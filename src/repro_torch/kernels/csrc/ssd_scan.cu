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
// Outputs: y (B, L, H, P) in xb's dtype, state (B, H, N, P) fp32. Scratch,
// allocated by the caller: states (B, n_chunks, H, N, P) fp32 and decay
// (B, n_chunks, H) fp32.
//
// Bound on an H100 SXM at the serving prefill (B=8, L=2081, H=32, P=64,
// N=128, chunk 256, bf16): C B^T once per batch row and chunk (5.4e8 FLOP
// on bf16 operands, 0.5 us at 989 TFLOP/s) and, per head, the causal G x,
// C S_prev and the state update (2.5e10 FLOP on fp32 decay-weighted
// operands, 0.37 ms at the 67 TFLOP/s of fp32 FMAs): 0.374 ms; the bytes
// (x and y 68 MB each, B, C, dt and the state 19 MB) take 0.046 ms.
//
// The launches are also exposed as two calls, for a sequence split over
// ranks: ssd_scan_states (launches 1-2, each chunk's entering state and
// total decay and the block's final state, all from zero) and
// ssd_scan_output (launch 3), which takes an optional initial state S_in
// (B, H, N, P) fp32 of the block. With S_in, launch 3 adds
// exp(cum from the block's start to chunk c's) S_in to chunk c's entering
// state as it loads it (the product of the chunk decays before c), so
// C . S_prev is one product as before, and blocks of chunk 0 write the
// final state exp(cum over the block) S_in + the block's own.
//
// Design. The TPU kernel walks the chunks on a sequential grid axis with
// the state in VMEM. Here the SSD decomposition runs as three launches, so
// that all but a short recurrence is parallel over chunks:
//  1. ssd_chunk_state, one block per (chunk, head, batch): the cumsum of
//     dt*A and the chunk's own state dS_c = sum_s exp(cum_end - cum_s)
//     B_s x_s^T into `states`, and exp(cum_end) into `decay`.
//  2. ssd_state_pass, a thread per four (n, p) of a (batch, head): the
//     recurrence S_c = exp(cum_end_c) S_{c-1} + dS_c over the chunks, in
//     place, so `states[c]` ends as the state entering chunk c; the last S
//     is the final state.
//  3. ssd_output, one block per (64-row query tile of a chunk, pair of
//     heads, batch), 128 threads a head, the late (heavy) tiles issued
//     first: C B^T of each key tile at or below the diagonal is computed
//     once for the pair (bf16: mma.sync m16n8k16, exact products, fp32
//     sums; fp32: FMAs, since TF32 would miss 2e-4), weighted by each
//     head's decay into G (entries above the diagonal selected to 0, never
//     multiplied: exp of a positive difference can overflow), and G x
//     summed on fp32 FMAs; on the diagonal tile a warp stops at its last
//     row. Then exp(cum_t) C_t . S_prev is added from `states` (chunk 0
//     has none). About 105 KB of
//     shared memory a block at N 128, P 64 in bf16, so two blocks share an
//     SM; the grid at the serving shape is 9 x 4 x 16 x 8 = 4608 blocks,
//     which keeps the last wave short.
// The decay-weighted products (G x, C S_prev, the state update) take fp32
// operands on fp32 FMAs, as the bound prices them. Ragged lengths are
// masked here: rows past L read as zero and take no part in the decay,
// which equals the reference's padding with x = 0, dt = 0 (decay exactly
// 1). Q = min(chunk, L) as in the reference, any Q up to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // rows of a sub-tile of the chunk in the outputs
constexpr int kStateTile = 32;      // rows of a sub-tile in the chunk states (static smem < 48 KB)
constexpr int kMaxChunk = 256;      // == kThreads: one thread per row in the cumsum
constexpr int kMaxN = 128;
constexpr int kHeadGroup = 2;       // heads of one output block, sharing its C B^T

// K consecutive outputs of a row in one store (K = 1, 2 or 4).
template <int K>
__device__ __forceinline__ void store_row(float* p, const float (&v)[K]) {
  if constexpr (K == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (K == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else *p = v[0];
}
template <int K>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&v)[K]) {
  if constexpr (K == 1) {
    *p = __float2bfloat16(v[0]);
  } else {
    uint32_t w[K / 2];
#pragma unroll
    for (int j = 0; j < K / 2; ++j) {
      __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<uint32_t*>(&b);
    }
    if constexpr (K == 4) *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// K consecutive floats of shared memory, aligned to min(16, 4K) bytes.
template <int K>
__device__ __forceinline__ void lds(float (&v)[K], const float* p) {
  if constexpr (K == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (K == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// Four consecutive elements of a tile row in shared memory, as floats.
__device__ __forceinline__ void lds4(float (&v)[4], const float* p) { lds<4>(v, p); }
__device__ __forceinline__ void lds4(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
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
  const float out = warp > 0 ? v + part[warp - 1] : v;
  __syncthreads();  // `part` may be reused by the next call
  return out;
}

// cum_t = sum_{s<=t} dt_s * A over the chunk's rows; rows past `len` (and a
// head past `heads`) add 0.
__device__ __forceinline__ float chunk_cumsum(const float* dt, const float* a_neg, size_t row0,
                                              int len, int heads, int h, float* part) {
  const int tid = threadIdx.x;
  const float loga = (tid < len && h < heads) ? dt[(row0 + tid) * heads + h] * a_neg[h] : 0.f;
  return block_cumsum(loga, part);
}

// 16 bytes holding T values, as floats (the last argument picks T).
__device__ __forceinline__ void widen_u4(float (&v)[4], uint4 u, float) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen_u4(float (&v)[8], uint4 u, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    v[2 * j] = __low2float(b);
    v[2 * j + 1] = __high2float(b);
  }
}

// 16 bytes of T at p (16-byte aligned), as floats.
template <typename T, int V>
__device__ __forceinline__ void widen_vec(float (&v)[V], const T* p) {
  widen_u4(v, *reinterpret_cast<const uint4*>(p), T{});
}

// Rows x cols of a row-major source with rows `ld` elements apart into
// dst[row * stride + col], 16 bytes a load: zero past `valid` rows and past
// column n. cols / (16 / sizeof(T)) is a power of two; n, ld and stride keep
// every vector 16-byte aligned. Each value is scaled by scale[row] if given.
template <int Rows, typename S, typename T>
__device__ __forceinline__ void load_tile(S* dst, int stride, const T* src, size_t ld,
                                          int valid, int n, int cols,
                                          const float* scale = nullptr) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V, shift = __ffs(vpr) - 1;
  for (int i = threadIdx.x; i < Rows * vpr; i += kThreads) {
    const int row = i >> shift, col = (i & (vpr - 1)) * V;
    float v[V];
    if (row < valid && col < n) {
      widen_vec(v, src + row * ld + col);
      if (scale != nullptr) {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] *= scale[row];
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    S* d = dst + row * stride + col;
    if constexpr (sizeof(S) == 2) {
      uint32_t w[V / 2];
#pragma unroll
      for (int j = 0; j < V / 2; ++j) {
        __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        w[j] = *reinterpret_cast<uint32_t*>(&b);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(d + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  }
}

// exp(x) of the decay weights in the outputs: for bf16 inputs the
// hardware's approximate exp2 (a few ulp, far inside the bf16 tolerance);
// for fp32 inputs expf, whose error the fp32 tolerance of 2e-4 needs where
// y is a small sum of large terms.
template <typename T>
__device__ __forceinline__ float decay_exp(float x) {
  if constexpr (sizeof(T) == 2) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
    return y;
  } else {
    return expf(x);
  }
}

// ---------------------------------------------------------------------------
// 1. Chunk states
// ---------------------------------------------------------------------------

// grid (n_chunks, heads, batch). A thread owns state rows n = ty*RN + r and
// columns p = tx*TN + c.
template <typename T, int TN, int RN>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_state(const T* __restrict__ xb, const float* __restrict__ dt,
                const float* __restrict__ a_neg, const T* __restrict__ bmat,
                float* __restrict__ states, float* __restrict__ decay, int len_total, int heads,
                int n_state, int chunk) {
  constexpr int P = 16 * TN, NN = 16 * RN;
  constexpr int kBStride = NN + 4, kXStride = P + 4;
  __shared__ __align__(16) float sB[kStateTile * kBStride];
  __shared__ __align__(16) float sX[kStateTile * kXStride];
  __shared__ float sW[kMaxChunk];
  __shared__ float sPart[kThreads / 32];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = c * chunk, len = min(chunk, len_total - c0);
  const size_t row0 = static_cast<size_t>(b) * len_total + c0;
  const size_t x_stride = static_cast<size_t>(heads) * P;

  const float cum = chunk_cumsum(dt, a_neg, row0, len, heads, h, sPart);
  sW[tid] = cum;
  __syncthreads();
  const float cum_end = sW[len - 1];
  __syncthreads();
  sW[tid] = tid < len ? expf(cum_end - cum) : 0.f;
  if (tid == 0) decay[(static_cast<size_t>(b) * gridDim.x + c) * heads + h] = expf(cum_end);

  float acc[RN][TN];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;

  for (int s0 = 0; s0 < len; s0 += kStateTile) {
    const int slen = min(kStateTile, len - s0);
    __syncthreads();  // the last tile's readers are done (and sW is written)
    load_tile<kStateTile>(sB, kBStride, bmat + (row0 + s0) * n_state, n_state, slen, n_state,
                          NN);
    // x weighted by its decay to the chunk's end
    load_tile<kStateTile>(sX, kXStride, xb + (row0 + s0) * x_stride + static_cast<size_t>(h) * P,
                          x_stride, slen, P, P, sW + s0);
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < slen; ++s) {
      float bv[RN], xv[TN];
      lds<RN>(bv, sB + s * kBStride + ty * RN);
      lds<TN>(xv, sX + s * kXStride + tx * TN);
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(bv[r], xv[j], acc[r][j]);
    }
  }

  float* out = states + ((static_cast<size_t>(b) * gridDim.x + c) * heads + h) * n_state * P;
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int n = ty * RN + r;
    if (n < n_state) store_row<TN>(out + n * P + tx * TN, acc[r]);
  }
}

// ---------------------------------------------------------------------------
// 2. The recurrence over chunks
// ---------------------------------------------------------------------------

// grid (ceil(N*P / 1024), heads, batch), four consecutive (n, p) a thread:
// states[c] <- the state entering chunk c; the state after the last chunk
// goes to `final_state`. The loads of up to kBatch chunks are issued
// together, so the recurrence waits on memory once per batch of chunks.
constexpr int kBatch = 8;

__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               float* __restrict__ final_state, int n_chunks, int heads, int np) {
  const int e = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (e >= np) return;
  const int h = blockIdx.y, b = blockIdx.z;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n_chunks; c0 += kBatch) {
    float4 d[kBatch];
    float a[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j < n_chunks) {
        const size_t bc = (static_cast<size_t>(b) * n_chunks + c0 + j) * heads + h;
        d[j] = *reinterpret_cast<const float4*>(states + bc * np + e);
        a[j] = decay[bc];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j < n_chunks) {
        const size_t bc = (static_cast<size_t>(b) * n_chunks + c0 + j) * heads + h;
        *reinterpret_cast<float4*>(states + bc * np + e) = s;
        s = make_float4(fmaf(a[j], s.x, d[j].x), fmaf(a[j], s.y, d[j].y),
                        fmaf(a[j], s.z, d[j].z), fmaf(a[j], s.w, d[j].w));
      }
    }
  }
  *reinterpret_cast<float4*>(final_state + (static_cast<size_t>(b) * heads + h) * np + e) = s;
}

// ---------------------------------------------------------------------------
// 3. Outputs
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// C_t . B_s for a 64 x 64 (t, s) tile: 16 values a thread, value i at
// (tb + cb_dt<T>(i), sb + cb_ds<T>(i)). bf16 on the tensor cores (warp w:
// rows 16 (w % 4).., keys 32 (w / 4).., mma fragments); fp32 on FMAs
// (t = ty*4 + r, s = tx + 16 c).
template <typename T>
__device__ __forceinline__ constexpr int cb_dt(int i) {
  return sizeof(T) == 2 ? 8 * ((i >> 1) & 1) : i >> 2;
}
template <typename T>
__device__ __forceinline__ constexpr int cb_ds(int i) {
  return sizeof(T) == 2 ? 8 * (i >> 2) + (i & 1) : 16 * (i & 3);
}

__device__ __forceinline__ void cb_tile(float (&cb)[16], int& tb, int& sb,
                                        const __nv_bfloat16* sC, const __nv_bfloat16* sB,
                                        int stride, int n_pad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tr = 16 * (warp & 3), sc = 32 * (warp >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) cb[i] = 0.f;
  for (int k0 = 0; k0 < n_pad; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, sC + (tr + (lane & 15)) * stride + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < 4; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (sc + (nt + (lane >> 4)) * 8 + (lane & 7)) * stride + k0 +
                         ((lane >> 3) & 1) * 8);
      mma_16816(cb + 4 * nt, a, b[0], b[1]);
      mma_16816(cb + 4 * nt + 4, a, b[2], b[3]);
    }
  }
  tb = tr + (lane >> 2);
  sb = sc + 2 * (lane & 3);
}

__device__ __forceinline__ void cb_tile(float (&cb)[16], int& tb, int& sb, const float* sC,
                                        const float* sB, int stride, int n_pad) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) cb[i] = 0.f;
  for (int n = 0; n < n_pad; n += 4) {
    float cv[4][4], bv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) lds<4>(cv[r], sC + (ty * 4 + r) * stride + n);
#pragma unroll
    for (int c = 0; c < 4; ++c) lds<4>(bv[c], sB + (tx + 16 * c) * stride + n);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[4 * r + c] = fmaf(cv[r][j], bv[c][j], cb[4 * r + c]);
  }
  tb = ty * 4;
  sb = tx;
}

// Row stride of the C and B tiles in shared memory, in elements: bf16 rows
// padded by 8 (16 bytes; ldmatrix reads are free of bank conflicts), fp32
// rows by 4.
template <typename T>
__host__ __device__ constexpr int tile_pad() { return sizeof(T) == 2 ? 8 : 4; }

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

template <typename T, int P>
__host__ __device__ inline size_t output_smem_bytes(int n_state) {
  const int stride = pad16(n_state) + tile_pad<T>();
  const size_t tiles = 2 * static_cast<size_t>(kTile) * stride * sizeof(T);  // C, B
  const size_t intra = (static_cast<size_t>(kTile) * (kHeadGroup * P + 4) +  // x
                        static_cast<size_t>(kHeadGroup) * kTile * (kTile + 4)) *  // G^T
                       sizeof(float);
  const size_t inter = static_cast<size_t>(kHeadGroup) * n_state * P * sizeof(float);  // S_prev
  return tiles + (intra > inter ? intra : inter) + kHeadGroup * kMaxChunk * sizeof(float);
}

// grid (n_chunks * query tiles a chunk, ceil(heads / kHeadGroup), batch):
// one 64-row query tile a block. Threads 128 g .. 128 g + 127 take head
// h0 + g; a thread owns y rows t = ty*8 + r of the tile and columns
// p = tx*TN + c.
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 2)
ssd_output(const T* __restrict__ xb, const float* __restrict__ dt,
           const float* __restrict__ a_neg, const T* __restrict__ bmat,
           const T* __restrict__ cmat, const float* __restrict__ states, T* __restrict__ y,
           int len_total, int heads, int n_state, int chunk,
           const float* __restrict__ decay, const float* __restrict__ s_in,
           const float* __restrict__ final0, float* __restrict__ final_out) {
  static_assert(kHeadGroup * 128 == kThreads, "128 threads a head");
  constexpr int P = 16 * TN, GP = kHeadGroup * P;
  constexpr int kXStride = GP + 4, kGStride = kTile + 4;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n_pad = pad16(n_state);
  const int stride = n_pad + tile_pad<T>();
  T* sC = reinterpret_cast<T*>(smem);                     // (kTile, stride): C of the query tile
  T* sB = sC + kTile * stride;                            // (kTile, stride): B of the key tile
  float* region = reinterpret_cast<float*>(sB + kTile * stride);
  float* sX = region;                                     // (kTile, kXStride): x of the group
  float* sG = sX + kTile * kXStride;                      // (group, kTile, kGStride): G^T[s][t]
  float* sS = region;                                     // (group, N, P): S_prev of each head
  const size_t intra = static_cast<size_t>(kTile) * kXStride + kHeadGroup * kTile * kGStride;
  const size_t inter = static_cast<size_t>(kHeadGroup) * n_state * P;
  float* sCum = region + (intra > inter ? intra : inter);  // (group, kMaxChunk)
  __shared__ float sPart[kThreads / 32];
  __shared__ float sWin[kHeadGroup], sWall[kHeadGroup];  // decay before chunk c, over all

  const int n_tiles = (chunk + kTile - 1) / kTile, n_chunks = (len_total + chunk - 1) / chunk;
  const int c = blockIdx.x / n_tiles, h0 = blockIdx.y * kHeadGroup, b = blockIdx.z;
  const int t0 = (n_tiles - 1 - blockIdx.x % n_tiles) * kTile;  // heavy (late) tiles first
  const int tid = threadIdx.x, g = tid >> 7, lt = tid & 127;
  const int tx = lt & 15, ty = lt >> 4, hw = lt >> 5;  // hw: the warp within the head
  const int h = h0 + g;
  const int c0 = c * chunk, len = min(chunk, len_total - c0);
  if (t0 >= len) return;  // the ragged last chunk has fewer query tiles
  const size_t row0 = static_cast<size_t>(b) * len_total + c0;
  const size_t x_stride = static_cast<size_t>(heads) * P;
  const int group = min(heads - h0, kHeadGroup);  // heads of this block
  const float* cum = sCum + g * kMaxChunk;
  const int np = n_state * P;

  if (s_in != nullptr) {
    // the decay from the block's start to chunk c's and over the whole block,
    // per head of the group; blocks of chunk 0 (none returned above) fold S_in
    // into the final state
    if (tid < group) {
      float w = 1.f;
      for (int j = 0; j < n_chunks; ++j) {
        if (j == c) sWin[tid] = w;
        w *= decay[(static_cast<size_t>(b) * n_chunks + j) * heads + h0 + tid];
      }
      sWall[tid] = w;
    }
    __syncthreads();
    if (blockIdx.x == 0) {
      const size_t base = (static_cast<size_t>(b) * heads + h0) * np;
      for (int i = 4 * tid; i < group * np; i += 4 * kThreads) {
        const float w = sWall[i / np];
        const float4 u = *reinterpret_cast<const float4*>(s_in + base + i);
        float4 v = *reinterpret_cast<const float4*>(final0 + base + i);
        v.x = fmaf(w, u.x, v.x); v.y = fmaf(w, u.y, v.y);
        v.z = fmaf(w, u.z, v.z); v.w = fmaf(w, u.w, v.w);
        *reinterpret_cast<float4*>(final_out + base + i) = v;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kHeadGroup; ++k)
    sCum[k * kMaxChunk + tid] = chunk_cumsum(dt, a_neg, row0, len, heads, h0 + k, sPart);

  {
    const int tlen = min(kTile, len - t0);
    __syncthreads();  // sCum is written
    load_tile<kTile>(sC, stride, cmat + (row0 + t0) * n_state, n_state, tlen, n_state, n_pad);

    float acc[8][TN];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;

    for (int s0 = 0; s0 <= t0; s0 += kTile) {
      const int slen = min(kTile, len - s0);
      __syncthreads();  // the last key tile's readers of sB, sX and sG are done
      load_tile<kTile>(sB, stride, bmat + (row0 + s0) * n_state, n_state, slen, n_state, n_pad);
      load_tile<kTile>(sX, kXStride, xb + (row0 + s0) * x_stride + static_cast<size_t>(h0) * P,
                       x_stride, slen, group * P, GP);
      __syncthreads();

      // G^T[s][t] = C_t . B_s exp(cum_t - cum_s) for s <= t, else 0, per head
      float cb[16];
      int tb, sb;
      cb_tile(cb, tb, sb, sC, sB, stride, n_pad);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int tl = tb + cb_dt<T>(i), sl = sb + cb_ds<T>(i);
        const int t = t0 + tl, s = s0 + sl;
#pragma unroll
        for (int k = 0; k < kHeadGroup; ++k) {
          const float* ck = sCum + k * kMaxChunk;
          sG[(k * kTile + sl) * kGStride + tl] = s <= t ? cb[i] * decay_exp<T>(ck[t] - ck[s]) : 0.f;
        }
      }
      __syncthreads();

      // y[t][p] += sum_s G^T[s][t] x[s][p]; on the diagonal tile a warp's
      // rows (16 hw .. 16 hw + 15) see keys up to their last row only
      const int s_end = s0 == t0 ? min(slen, 16 * hw + 16) : slen;
      const float* gk = sG + g * kTile * kGStride + ty * 8;
      const float* xk = sX + g * P + tx * TN;
#pragma unroll 4
      for (int s = 0; s < s_end; ++s) {
        float gv[8], xv[TN];
        lds<8>(gv, gk + s * kGStride);
        lds<TN>(xv, xk + s * kXStride);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(gv[r], xv[j], acc[r][j]);
      }
    }

    // inter-chunk term: y_t += exp(cum_t) C_t . S_prev (no state enters chunk 0
    // but S_in); S_prev = the entering state from zero + the decayed S_in
    if (c > 0 || s_in != nullptr) {
      __syncthreads();  // readers of the region (sX, sG) are done
      const float* src = states + ((static_cast<size_t>(b) * n_chunks + c) * heads + h0) *
                                      np;  // the group's heads are adjacent
      const float* init = s_in + (static_cast<size_t>(b) * heads + h0) * np;
      for (int i = 4 * tid; i < group * np; i += 4 * kThreads) {
        float4 v = *reinterpret_cast<const float4*>(src + i);
        if (s_in != nullptr) {
          const float w = sWin[i / np];
          const float4 u = *reinterpret_cast<const float4*>(init + i);
          v.x = fmaf(w, u.x, v.x); v.y = fmaf(w, u.y, v.y);
          v.z = fmaf(w, u.z, v.z); v.w = fmaf(w, u.w, v.w);
        }
        *reinterpret_cast<float4*>(sS + i) = v;
      }
      __syncthreads();
      float cs[8][TN];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) cs[r][j] = 0.f;
      const float* sk = sS + g * n_state * P + tx * TN;
      for (int n = 0; n < n_state; n += 4) {
        float sv[4][TN];
#pragma unroll
        for (int k = 0; k < 4; ++k) lds<TN>(sv[k], sk + (n + k) * P);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float cv[4];
          lds4(cv, sC + (ty * 8 + r) * stride + n);
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int j = 0; j < TN; ++j) cs[r][j] = fmaf(cv[k], sv[k][j], cs[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float e = decay_exp<T>(cum[t0 + ty * 8 + r]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(e, cs[r][j], acc[r][j]);
      }
    }

    if (h < heads) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int t = ty * 8 + r;
        if (t < tlen) {
          store_row<TN>(y + (row0 + t0 + t) * x_stride + static_cast<size_t>(h) * P + tx * TN,
                        acc[r]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Args {
  const void *xb, *dt, *a_neg, *bmat, *cmat;
  void *y, *state, *states, *decay;
  int batch, len, heads, n_state, chunk, n_chunks;
  cudaStream_t stream;
  const void* s_in;  // the output call's initial state, or null
  void* final_out;   // with s_in: the final state including it
};

template <typename T, int TN, int RN>
int launch_chunk_state(const Args& a) {
  ssd_chunk_state<T, TN, RN><<<dim3(a.n_chunks, a.heads, a.batch), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.xb), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.a_neg), static_cast<const T*>(a.bmat),
      static_cast<float*>(a.states), static_cast<float*>(a.decay), a.len, a.heads, a.n_state,
      a.chunk);
  return static_cast<int>(cudaGetLastError());
}

// launches 1-2
template <typename T, int TN>
int launch_states(const Args& a) {
  constexpr int P = 16 * TN;
  int err;
  if (a.n_state <= 16) err = launch_chunk_state<T, TN, 1>(a);
  else if (a.n_state <= 32) err = launch_chunk_state<T, TN, 2>(a);
  else if (a.n_state <= 64) err = launch_chunk_state<T, TN, 4>(a);
  else err = launch_chunk_state<T, TN, 8>(a);
  if (err) return err;

  const int np = a.n_state * P;
  ssd_state_pass<<<dim3((np + 4 * kThreads - 1) / (4 * kThreads), a.heads, a.batch), kThreads, 0,
                   a.stream>>>(static_cast<float*>(a.states), static_cast<const float*>(a.decay),
                               static_cast<float*>(a.state), a.n_chunks, a.heads, np);
  return static_cast<int>(cudaGetLastError());
}

// launch 3
template <typename T, int TN>
int launch_output(const Args& a) {
  constexpr int P = 16 * TN;
  static bool attribute_set = false;  // once per process and instance, for the largest N
  if (!attribute_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_output<T, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(output_smem_bytes<T, P>(kMaxN)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set = true;
  }
  const size_t smem = output_smem_bytes<T, P>(a.n_state);
  const dim3 grid(a.n_chunks * ((a.chunk + kTile - 1) / kTile),
                  (a.heads + kHeadGroup - 1) / kHeadGroup, a.batch);
  ssd_output<T, TN><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.xb), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.a_neg), static_cast<const T*>(a.bmat),
      static_cast<const T*>(a.cmat), static_cast<const float*>(a.states), static_cast<T*>(a.y),
      a.len, a.heads, a.n_state, a.chunk, static_cast<const float*>(a.decay),
      static_cast<const float*>(a.s_in), static_cast<const float*>(a.state),
      static_cast<float*>(a.final_out));
  return static_cast<int>(cudaGetLastError());
}

enum Part { kStates = 1, kOutput = 2, kBoth = 3 };

template <typename T, int TN>
int launch(const Args& a, int part) {
  if (part & kStates) {
    const int err = launch_states<T, TN>(a);
    if (err) return err;
  }
  return part & kOutput ? launch_output<T, TN>(a) : 0;
}

template <typename T>
int dispatch(int head_dim, const Args& a, int part) {
  switch (head_dim) {
    case 16: return launch<T, 1>(a, part);
    case 32: return launch<T, 2>(a, part);
    case 64: return launch<T, 4>(a, part);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(const Args& a, int head_dim, int is_bf16, int part) {
  if (a.chunk < 1 || a.chunk > kMaxChunk || a.n_state < 8 || a.n_state > kMaxN ||
      a.n_state % 8 || a.len < 1 || a.batch < 1 || a.heads < 1 ||
      a.n_chunks != (a.len + a.chunk - 1) / a.chunk || a.batch > 65535 || a.heads > 65535 ||
      (a.s_in != nullptr && a.final_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) return dispatch<__nv_bfloat16>(head_dim, a, part);
  return dispatch<float>(head_dim, a, part);
}

}  // namespace

// xb (batch, len, heads, head_dim), bmat/cmat (batch, len, n_state): contiguous,
// bf16 if is_bf16 else fp32; dt (batch, len, heads) and a_neg (heads,) fp32.
// Writes y like xb and state (batch, heads, n_state, head_dim) fp32, using
// the caller's scratch states (batch, n_chunks, heads, n_state, head_dim)
// and decay (batch, n_chunks, heads), both fp32. chunk is the reference's
// min(chunk, len), 1..256, n_chunks = ceil(len / chunk); head_dim
// 16, 32 or 64; n_state a multiple of 8 up to 128. Issues three launches
// on `stream` and returns the first failing cudaError_t (0 on success); it
// does not synchronise.
extern "C" int ssd_scan_forward(const void* xb, const void* dt, const void* a_neg,
                                const void* bmat, const void* cmat, void* y, void* state,
                                void* states, void* decay, int batch, int len, int heads,
                                int head_dim, int n_state, int chunk, int n_chunks,
                                int is_bf16, void* stream) {
  const Args a{xb, dt, a_neg, bmat, cmat, y, state, states, decay,
               batch, len, heads, n_state, chunk, n_chunks, static_cast<cudaStream_t>(stream),
               nullptr, nullptr};
  return run(a, head_dim, is_bf16, kBoth);
}

// Launches 1-2 alone: states (the state entering each chunk), decay (each
// chunk's total decay) and state (the block's final state), all from zero,
// as ssd_scan_forward leaves them; cmat and y are not read.
extern "C" int ssd_scan_states(const void* xb, const void* dt, const void* a_neg,
                               const void* bmat, void* state, void* states, void* decay,
                               int batch, int len, int heads, int head_dim, int n_state,
                               int chunk, int n_chunks, int is_bf16, void* stream) {
  const Args a{xb, dt, a_neg, bmat, bmat, nullptr, state, states, decay,
               batch, len, heads, n_state, chunk, n_chunks, static_cast<cudaStream_t>(stream),
               nullptr, nullptr};
  return run(a, head_dim, is_bf16, kStates);
}

// Launch 3 alone, on ssd_scan_states' states, decay and final state (read
// only). With s_in (batch, heads, n_state, head_dim) fp32, the block starts
// from it: y takes its decayed share, and final_out (like s_in, distinct
// from state) gets the final state; s_in null reads as zero and leaves
// final_out unwritten.
extern "C" int ssd_scan_output(const void* xb, const void* dt, const void* a_neg,
                               const void* bmat, const void* cmat, const void* states,
                               const void* decay, const void* state, const void* s_in,
                               void* y, void* final_out, int batch, int len, int heads,
                               int head_dim, int n_state, int chunk, int n_chunks, int is_bf16,
                               void* stream) {
  const Args a{xb, dt, a_neg, bmat, cmat, y, const_cast<void*>(state),
               const_cast<void*>(states), const_cast<void*>(decay),
               batch, len, heads, n_state, chunk, n_chunks, static_cast<cudaStream_t>(stream),
               s_in, final_out};
  return run(a, head_dim, is_bf16, kOutput);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
