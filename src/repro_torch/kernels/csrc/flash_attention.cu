// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel, launched by flash_attention_bhsd through pl.pallas_call):
// blockwise online-softmax attention over q, k, v of shape (BH, S, d),
// scale 1/sqrt(d), fp32 running max, sum and accumulator, causal mask
// aligned top-left (query i sees keys 0..i), masked scores -1e30, the final
// sum clamped at 1e-30, output in the input dtype.
//
// Design. The TPU kernel walks a sequential grid axis over k-blocks and
// carries its statistics in VMEM scratch between grid steps. Blocks on a
// GPU run in no order, so here one block owns one (bh, q-tile) and loops
// over k-tiles itself, staging each K/V tile in shared memory and keeping
// the statistics and accumulator in registers. Under causal masking the
// loop stops at the diagonal tile, and heavy (late) q-tiles are issued
// first. Ragged lengths are masked here (key >= Sk scores -1e30, zero K/V
// rows, rows >= Sq not stored), so any S works, not only multiples of the
// tile.
//
//  * bf16: 4 warps x 16 query rows, 64-key tiles. Q K^T and P V run on
//    the tensor cores through mma.sync m16n8k16 (bf16 in, fp32 out); the
//    score fragment of Q K^T is re-packed in registers as the A operand of
//    P V, so scores never leave registers. K and V fragments come from
//    shared memory with ldmatrix (V transposed); rows are padded by 8
//    elements so those reads are free of bank conflicts.
//  * fp32: a quad of threads per query row, each owning every 4th head
//    dim, with plain FMAs in fp32 (tensor cores would round to TF32 and
//    miss the fp32 tolerance of 3e-5).
//
// Bound on an H100 SXM for the serving prefill this slice runs (B=8, H=14,
// S=2081, d=64, causal, bf16): 4*d*S*(S+1)/2*B*H = 6.2e10 FLOP, 63 us at
// 989 TFLOP/s; q, k, v read once and o written once are 119 MB, 36 us at
// 3.35 TB/s. The work is compute-bound, so what matters is tensor-core
// issue rate; wgmma and TMA (not used yet) are the way to its peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;  // 4 warps x 16 rows
constexpr int kBlockK = 64;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two floats -> one register of two bf16, `lo` in the low half (lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int sq, int sk, float scale, int causal) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim must be 16, 32, 64 or 128");
  constexpr int kStride = D + 8;   // padded smem row, in elements
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockK * kStride];

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heaviest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const size_t qbase = static_cast<size_t>(bh) * sq * D;
  const size_t kbase = static_cast<size_t>(bh) * sk * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // the two rows this thread holds
  const float scale_log2 = scale * kLog2e;

  // Q as mma A fragments, straight from global memory; rows >= sq read as 0.
  uint32_t qa[D / 16][4];
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + qbase);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = (ks * 16 + 2 * t) / 2;  // column pair, in 32-bit words
    qa[ks][0] = r0 < sq ? q32[static_cast<size_t>(r0) * (D / 2) + c] : 0u;
    qa[ks][1] = r1 < sq ? q32[static_cast<size_t>(r1) * (D / 2) + c] : 0u;
    qa[ks][2] = r0 < sq ? q32[static_cast<size_t>(r0) * (D / 2) + c + 4] : 0u;
    qa[ks][3] = r1 < sq ? q32[static_cast<size_t>(r1) * (D / 2) + c + 4] : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
  float l[2] = {0.f, 0.f};          // running sum, partial over this thread's columns

  const int q_last = min(q0 + kBlockQ, sq) - 1;
  int n_tiles = (sk + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, q_last / kBlockK + 1);

  // ldmatrix lane roles: lanes 8i..8i+7 address the rows of 8x8 matrix i.
  const int lm_row = lane & 7, lm_mat = lane >> 3;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
      const int row = i / kChunks, ch = i % kChunks;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + row < sk) {
        const size_t off = kbase + static_cast<size_t>(k0 + row) * D + ch * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&sK[row * kStride + ch * 8]) = kv;
      *reinterpret_cast<uint4*>(&sV[row * kStride + ch * 8]) = vv;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ks += 2) {
        // matrices: keys nt*8.., dims (ks*16 + 8*lm_mat)..; they are the
        // B fragments (b0, b1) of k-step ks and, for lm_mat 2..3, ks + 1.
        uint32_t b[4];
        if (ks + 1 < D / 16) {
          ldmatrix_x4(b, &sK[(nt * 8 + lm_row) * kStride + ks * 16 + lm_mat * 8]);
          mma_16816(s[nt], qa[ks], b[0], b[1]);
          mma_16816(s[nt], qa[ks + 1], b[2], b[3]);
        } else {  // D == 16: one k-step, the upper two matrices repeat the lower
          ldmatrix_x4(b, &sK[(nt * 8 + lm_row) * kStride + (lm_mat & 1) * 8]);
          mma_16816(s[nt], qa[ks], b[0], b[1]);
        }
      }
    }

    // Scale into log2 units and mask the ragged tail and the diagonal tile.
    const bool edge = (k0 + kBlockK > sk) || (causal && k0 + kBlockK - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (key >= sk || (causal && key > row)) x = kNegInf;
        }
        s[nt][e] = x;
      }
    }

    // Online softmax; a row's 64 scores live in the 4 threads of a quad.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha0 = exp2f(m[0] - mx[0]), alpha1 = exp2f(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx[0]);
      s[nt][1] = exp2f(s[nt][1] - mx[0]);
      s[nt][2] = exp2f(s[nt][2] - mx[1]);
      s[nt][3] = exp2f(s[nt][3] - mx[1]);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l[0] = l[0] * alpha0 + rs0;
    l[1] = l[1] * alpha1 + rs1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha0;
      acc[dn][1] *= alpha0;
      acc[dn][2] *= alpha1;
      acc[dn][3] *= alpha1;
    }

    // O += P V. The C fragments of two adjacent score n-tiles are exactly
    // the A fragment of one 16-key k-step.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        // matrices (transposed): keys kk*16 + 8*(lm_mat&1).., dims
        // (dn + (lm_mat>>1))*8..; they are (b0, b1) of dims tile dn, then dn+1.
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, &sV[(kk * 16 + (lm_mat & 1) * 8 + lm_row) * kStride + (dn + (lm_mat >> 1)) * 8]);
        mma_16816(acc[dn], pa, b[0], b[1]);
        mma_16816(acc[dn + 1], pa, b[2], b[3]);
      }
    }
  }

  // Finish: full row sums across the quad, clamp, normalise, store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  uint32_t* o32 = reinterpret_cast<uint32_t*>(o + qbase);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = (dn * 8 + 2 * t) / 2;
    if (r0 < sq)
      o32[static_cast<size_t>(r0) * (D / 2) + c] = pack_bf16(acc[dn][0] / l[0], acc[dn][1] / l[0]);
    if (r1 < sq)
      o32[static_cast<size_t>(r1) * (D / 2) + c] = pack_bf16(acc[dn][2] / l[1], acc[dn][3] / l[1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: FMAs, one quad of threads per query row
// ---------------------------------------------------------------------------

constexpr int kF32BlockQ = kThreads / 4;
constexpr int kF32BlockK = 32;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
              float scale, int causal) {
  constexpr int C = D / 4;  // this thread owns head dims c*4 + t, c < C
  __shared__ float sK[kF32BlockK][D];
  __shared__ float sV[kF32BlockK][D];

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32BlockQ;
  const int t = threadIdx.x & 3;
  const int row = q0 + (threadIdx.x >> 2);
  const bool valid = row < sq;
  const size_t qbase = static_cast<size_t>(bh) * sq * D;
  const size_t kbase = static_cast<size_t>(bh) * sk * D;

  float qr[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = valid ? q[qbase + static_cast<size_t>(row) * D + c * 4 + t] * scale : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int q_last = min(q0 + kF32BlockQ, sq) - 1;
  int n_tiles = (sk + kF32BlockK - 1) / kF32BlockK;
  if (causal) n_tiles = min(n_tiles, q_last / kF32BlockK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32BlockK;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < sk;
      const size_t off = kbase + static_cast<size_t>(k0 + r) * D + c;
      sK[r][c] = in ? k[off] : 0.f;
      sV[r][c] = in ? v[off] : 0.f;
    }
    __syncthreads();

    float s[kF32BlockK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32BlockK; ++j) {
      float p = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) p = fmaf(qr[c], sK[j][c * 4 + t], p);
      p += __shfl_xor_sync(0xffffffffu, p, 1);  // the quad's four partial dots
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      const int key = k0 + j;
      if (key >= sk || (causal && key > row)) p = kNegInf;
      s[j] = p;
      mx = fmaxf(mx, p);
    }
    const float alpha = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kF32BlockK; ++j) {
      s[j] = expf(s[j] - mx);
      rs += s[j];
    }
    l = l * alpha + rs;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32BlockK; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(s[j], sV[j][c * 4 + t], acc[c]);
    }
  }

  if (valid) {
    l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) o[qbase + static_cast<size_t>(row) * D + c * 4 + t] = acc[c] / l;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
            int is_bf16, int causal, float scale, cudaStream_t stream) {
  if (is_bf16) {
    dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
    flash_fwd_bf16<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, scale,
        causal);
  } else {
    dim3 grid((sq + kF32BlockQ - 1) / kF32BlockQ, bh);
    flash_fwd_f32<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, scale, causal);
  }
}

}  // namespace

// q (bh, sq, d), k/v (bh, sk, d), o (bh, sq, d): contiguous, one dtype
// (bf16 if is_bf16 else fp32). Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       int bh, int sq, int sk, int d, int is_bf16, int causal,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: launch<16>(q, k, v, o, bh, sq, sk, is_bf16, causal, scale, st); break;
    case 32: launch<32>(q, k, v, o, bh, sq, sk, is_bf16, causal, scale, st); break;
    case 64: launch<64>(q, k, v, o, bh, sq, sk, is_bf16, causal, scale, st); break;
    case 128: launch<128>(q, k, v, o, bh, sq, sk, is_bf16, causal, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
