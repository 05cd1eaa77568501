// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel, launched by flash_attention_bhsd through pl.pallas_call):
// blockwise online-softmax attention, scale 1/sqrt(d), fp32 running max,
// sum and accumulator, causal mask aligned top-left (query i sees keys
// 0..i; with q_offset, keys 0..i + q_offset, the queries being a block of
// the sequence that starts at position q_offset), masked scores -1e30, the final sum clamped at 1e-30, output in the
// input dtype.
//
// Layout. q and o are (B, Sq, H, d) and k, v (B, Sk, KV, d), the model's own
// layout, with KV dividing H: head h reads KV head h / (H / KV), so grouped
// K/V are never broadcast to H heads and nothing is transposed or copied
// around the kernel. The reference's (BH, S, d) form is the case B = BH,
// H = KV = 1.
//
// Bound on an H100 SXM at the serving prefill (B=8, H=14, S=2081, d=64,
// causal, bf16): 4*d*S*(S+1)/2*B*H = 6.2e10 FLOP, 63 us at 989 TFLOP/s;
// q, k, v read once and o written once are 119 MB, 36 us at 3.35 TB/s. The
// work is bound by the tensor cores' rate, which only wgmma reaches.
//
//  * bf16 (flash_fwd_bf16): a block owns a q-tile of one (batch, head):
//    three consumer warpgroups of 64 rows (two at d 128, whose
//    accumulators need the registers) and a producer warpgroup, one thread
//    of which issues every load while the rest give their registers to the
//    consumers (setmaxnreg). K/V are read again for each q-tile, from L2,
//    so the larger the q-tile, the fewer the bytes a product waits on. The
//    producer loads Q once and keeps 128-key K/V tiles in flight by TMA
//    through a three-stage ring in shared memory, guarded by mbarriers
//    (full: bytes landed; empty: every consumer warp done). TMA fills rows
//    past Sq or Sk with zeros and swizzles each tile (128, 64 or 32 bytes,
//    by the row width) as the wgmma descriptors expect. S = Q K^T runs as
//    wgmma m64n128k16 with both operands in shared memory; P V as wgmma
//    with P in registers (the S accumulator re-packed as bf16 A fragments)
//    and V from shared memory as an MN-major B operand, so scores never
//    leave registers. A warpgroup issues S of tile j with P V of tile j-1
//    and runs the softmax of tile j while P V is on the tensor cores; the
//    warpgroups take turns to issue (named barriers, round robin). Causal
//    tiles past the block's last query row are never loaded, and heavy
//    q-tiles are issued first. The skip is per block: every warpgroup runs
//    all the block's tiles, so the first warpgroups' rows of the last one
//    or two tiles lie wholly above their diagonal and are masked like the
//    diagonal tiles (and the ragged key tail).
//  * fp32 (flash_fwd_f32): a quad of threads per query row, each owning
//    every 4th head dim, with plain FMAs in fp32 (tensor cores would round
//    to TF32 and miss the fp32 tolerance of 3e-5).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wrong parity
// would spin forever; after about ten seconds this traps instead, so the
// launch fails with an error rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      asm volatile("trap;");
    }
  }
}

// One box of a 4-d tensor map (d, heads, seq, batch) into shared memory,
// completing `bytes` on the mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warp are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 .. 3 order the consumer warpgroups' wgmma issue
// (barrier 0 is __syncthreads).
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator registers are named in full in each instruction, so each
// width has its own wrapper. ss: A and B both K-major in shared memory.
// rs: A in registers, B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, "
      "1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, "
      "1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kBlockK = 128;
constexpr int kStages = 3;  // P V of a tile and S of the next hold two
constexpr int kProducerRegs = 24;

// The geometry of one head dim. Consumer warpgroups own 64 q rows each:
// three up to d 64, so each K/V tile serves 192 queries (K/V are read
// again for each q-tile, from L2), two at d 128 for registers. A producer
// warpgroup gives up all but 24 registers a thread to them.
template <int D>
struct Geom {
  static constexpr int kWarpgroups = D <= 64 ? 3 : 2;  // consumers
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kConsumerRegs = D <= 64 ? 160 : 240;
  static constexpr int kBlockQ = 64 * kWarpgroups;
  // Tiles are stored as kRegions column regions of kCols columns (rows of
  // kRowBytes bytes, at most one 128-byte swizzle row), each as TMA writes
  // one box.
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRegions = D / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kAtom = 8 * kRowBytes;  // bytes of 8 rows: one swizzle atom
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kTileBytes = kBlockK * D * 2;  // one K or one V tile
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;  // + alignment
  static_assert(kWarpgroups * kConsumerRegs * 128 + kProducerRegs * 128 <= 65536,
                "registers of the block");
};

// Two floats -> one register of two bf16, `lo` in the low half (lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t desc) {
  if constexpr (D == 16) wgmma_rs_n16(o, a, desc, 1);
  else if constexpr (D == 32) wgmma_rs_n32(o, a, desc, 1);
  else wgmma_rs_n64(o, a, desc, 1);
}

// q/o (B, Sq, H, D) and k/v (B, Sk, KV, D) through tensor maps with dims
// (D, heads, seq, batch); grid (B*H, q-tiles).
template <int D>
__global__ void __launch_bounds__(Geom<D>::kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
               int sq, int sk, int heads, int group, float scale, int causal, int q_offset) {
  using G = Geom<D>;
  static_assert(D % 16 == 0 && D <= 128, "head_dim must be 16, 32, 64 or 128");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // Q, full[], empty[]

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + G::kQBytes;                    // stage s at sK + s * kTileBytes
  const uint32_t sV = sK + kStages * G::kTileBytes;
  const uint32_t barQ = smem_u32(&bars[0]);
  const uint32_t barFull = smem_u32(&bars[1]);            // + 8 * stage
  const uint32_t barEmpty = smem_u32(&bars[1 + kStages]);

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::kBlockQ;  // heaviest tiles first
  const int q_last = min(q0 + G::kBlockQ, sq) - 1;
  int n_tiles = (sk + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (q_last + q_offset) / kBlockK + 1);

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(barFull + 8 * s, 1);
      mbar_init(barEmpty + 8 * s, G::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= G::kConsumers / 32) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == G::kConsumers / 32 && lane == 0) {
      mbar_expect_tx(barQ, G::kQBytes);
      for (int r = 0; r < G::kRegions; ++r)
        tma_load_4d(sQ + r * G::kBlockQ * G::kRowBytes, &map_q, barQ, r * G::kCols, h, q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int stage = kt % kStages;
        if (kt >= kStages) mbar_wait(barEmpty + 8 * stage, ((kt / kStages) - 1) & 1);
        const uint32_t full = barFull + 8 * stage;
        mbar_expect_tx(full, 2 * G::kTileBytes);
        for (int r = 0; r < G::kRegions; ++r) {
          const uint32_t off = stage * G::kTileBytes + r * kBlockK * G::kRowBytes;
          tma_load_4d(sK + off, &map_k, full, r * G::kCols, kvh, kt * kBlockK, b);
          tma_load_4d(sV + off, &map_v, full, r * G::kCols, kvh, kt * kBlockK, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs));
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;             // accumulator row group / column pair
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + g;  // the two rows this thread holds
  const int rows[2] = {r0, r0 + 8};
  const float scale_log2 = scale * kLog2e;

  float s[kBlockK / 2];  // S accumulator: s[4j + e] is row rows[e >> 1], key 8j + 2t + (e & 1)
  float acc[D / 2];      // O accumulator, the same layout over head dims
  uint32_t pa[kBlockK / 16][4];  // P of the last tile as bf16 A fragments
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // running sum, partial over this thread's columns

  // S = Q K^T of one stage, issued and committed as one wgmma group; a
  // k-step is 32 bytes into a swizzled row.
  auto issue_qk = [&](int stage) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int r = ks * 16 / G::kCols, cb = (ks * 16 % G::kCols) * 2;
      const uint64_t da = make_desc(sQ + (r * G::kBlockQ + wg * 64) * G::kRowBytes + cb, 16,
                                    G::kAtom, G::kSwizzle);
      const uint64_t db = make_desc(sK + stage * G::kTileBytes + r * kBlockK * G::kRowBytes + cb,
                                    16, G::kAtom, G::kSwizzle);
      wgmma_ss_n128(s, da, db, ks > 0);
    }
    wgmma_commit();
  };
  // O += P V of one stage; V's k-step is 16 rows down. MN-major B: 8-row
  // groups kAtom apart, both offsets set to it (a region holds one swizzle
  // row of columns).
  auto issue_pv = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < G::kRegions; ++r) {
        const uint64_t dv = make_desc(
            sV + stage * G::kTileBytes + r * kBlockK * G::kRowBytes + kk * 16 * G::kRowBytes,
            G::kAtom, G::kAtom, G::kSwizzle);
        wgmma_pv<D>(acc + r * (G::kCols / 2), pa[kk], dv);
      }
    }
    wgmma_commit();
  };
  // Mask, new running max, P = exp2((S - max) * scale * log2 e) in s, and
  // the rescale factor of the earlier state; touches s, m and l only.
  auto softmax = [&](int k0, float (&alpha)[2]) {
    if ((k0 + kBlockK > sk) || (causal && k0 + kBlockK - 1 > r0 - g + q_offset)) {
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) {  // ragged tail, diagonal
        const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (key >= sk || (causal && key > rows[(i >> 1) & 1] + q_offset)) s[i] = kNegInf;
      }
    }
    // A row's 128 scores live in the 4 threads of a quad. Maxima and sums
    // run as four partial chains a row, so that few warps still hide the
    // latency of each step.
    float part[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) part[r][k] = m[r];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      float& p = part[(i >> 1) & 1][(i >> 2) & 3];
      p = fmaxf(p, s[i]);
    }
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float base[2] = {mx[0] * scale_log2, mx[1] * scale_log2};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) part[r][k] = 0.f;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -base[r]));
      part[r][(i >> 2) & 3] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      l[r] = l[r] * alpha[r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
    }
  };
  // P as the A fragments of P V: the accumulators of two adjacent 8-key
  // blocks are exactly the A fragment of one 16-key k-step.
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  };
  // The warpgroups take turns to issue, round robin: each waits on its own
  // named barrier (1 + wg), which the one before it arrives at once it has
  // issued, so the others' softmax runs while one's products hold the
  // tensor cores.
  constexpr int kW = G::kWarpgroups;
  auto begin_issue = [&]() {
    named_bar_sync(1 + wg, 256);
    wgmma_fence();
  };
  auto end_issue = [&]() { named_bar_arrive(1 + (wg + 1) % kW, 256); };
  auto release = [&](int stage) {
    if (lane == 0) mbar_arrive(barEmpty + 8 * stage);  // this warp is done with the stage
  };

  // Tile 0, then for each later tile: S of this tile and P V of the last
  // one are in flight together; the softmax of this tile runs while P V
  // does. A stage is released once its P V has completed.
  if (wg == kW - 1) named_bar_arrive(1, 256);  // warpgroup 0 issues first
  mbar_wait(barQ, 0);
  mbar_wait(barFull, 0);
  float alpha[2];
  begin_issue();
  issue_qk(0);
  end_issue();
  wgmma_wait<0>();
  softmax(0, alpha);
  pack_p();
  for (int kt = 1; kt < n_tiles; ++kt) {
    const int stage = kt % kStages, prev = (kt - 1) % kStages;
    mbar_wait(barFull + 8 * stage, (kt / kStages) & 1);
    begin_issue();
    issue_qk(stage);
    issue_pv(prev);
    end_issue();
    wgmma_wait<1>();  // S is in; P V may still run
    softmax(kt * kBlockK, alpha);
    wgmma_wait<0>();
    release(prev);
    rescale(alpha);
    pack_p();
  }
  const int last = (n_tiles - 1) % kStages;
  begin_issue();
  issue_pv(last);
  if (wg != kW - 1) end_issue();  // every arrive meets a sync
  wgmma_wait<0>();
  release(last);

  // Finish: full row sums across the quad, clamp, normalise, store.
  const size_t row_stride = static_cast<size_t>(heads) * D;
  __nv_bfloat16* ob = o + (static_cast<size_t>(b) * sq) * row_stride + static_cast<size_t>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < sq)
        *reinterpret_cast<uint32_t*>(ob + rows[r] * row_stride + c) =
            pack_bf16(acc[4 * j + 2 * r] * l[r], acc[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMAs, one quad of threads per query row
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32BlockQ = kF32Threads / 4;
constexpr int kF32BlockK = 32;

// q/o (B, Sq, H, D), k/v (B, Sk, KV, D); grid (B*H, q-tiles).
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq, int sk, int heads,
              int group, float scale, int causal, int q_offset) {
  constexpr int C = D / 4;  // this thread owns head dims c*4 + t, c < C
  __shared__ float sK[kF32BlockK][D];
  __shared__ float sV[kF32BlockK][D];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int kv_heads = heads / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BlockQ;
  const int t = threadIdx.x & 3;
  const int row = q0 + (threadIdx.x >> 2);
  const bool valid = row < sq;
  const size_t q_stride = static_cast<size_t>(heads) * D;  // between rows of q and o
  const size_t kv_stride = static_cast<size_t>(kv_heads) * D;
  const size_t qbase = static_cast<size_t>(b) * sq * q_stride + static_cast<size_t>(h) * D;
  const size_t kbase =
      static_cast<size_t>(b) * sk * kv_stride + static_cast<size_t>(h / group) * D;

  float qr[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = valid ? q[qbase + row * q_stride + c * 4 + t] * scale : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int q_last = min(q0 + kF32BlockQ, sq) - 1;
  int n_tiles = (sk + kF32BlockK - 1) / kF32BlockK;
  if (causal) n_tiles = min(n_tiles, (q_last + q_offset) / kF32BlockK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32BlockK;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BlockK * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < sk;
      const size_t off = kbase + (k0 + r) * kv_stride + c;
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
      if (key >= sk || (causal && key > row + q_offset)) p = kNegInf;
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
    for (int c = 0; c < C; ++c) o[qbase + row * q_stride + c * 4 + t] = acc[c] / l;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; it is reached through
// the runtime's entry-point query, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, heads, seq, batch) bf16 tensor map whose box is one swizzle row of
// columns by `rows` rows of one (batch, head).
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int rows) {
  using G = Geom<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(seq) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kCols), 1, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = G::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int sq, int sk,
           int heads, int kv_heads, int is_bf16, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  const int group = heads / kv_heads;
  if (is_bf16) {
    CUtensorMap mq, mk, mv;
    int err = make_map<D>(&mq, q, batch, sq, heads, Geom<D>::kBlockQ);
    if (!err) err = make_map<D>(&mk, k, batch, sk, kv_heads, kBlockK);
    if (!err) err = make_map<D>(&mv, v, batch, sk, kv_heads, kBlockK);
    if (err) return err;
    const int smem = Geom<D>::kSmem;
    static bool attribute_set = false;  // once per process and instance
    if (!attribute_set) {
      cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      attribute_set = true;
    }
    dim3 grid(batch * heads, (sq + Geom<D>::kBlockQ - 1) / Geom<D>::kBlockQ);
    flash_fwd_bf16<D><<<grid, Geom<D>::kThreads, smem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), sq, sk, heads, group, scale, causal,
        q_offset);
  } else {
    dim3 grid(batch * heads, (sq + kF32BlockQ - 1) / kF32BlockQ);
    flash_fwd_f32<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, heads, group, scale,
        causal, q_offset);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (batch, sq, heads, d), k/v (batch, sk, kv_heads, d), o like q:
// contiguous, one dtype (bf16 if is_bf16 else fp32), kv_heads dividing
// heads, 16-byte aligned; q_offset (>= 0) is the first query's position
// among the keys under the causal mask. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       int batch, int sq, int sk, int heads, int kv_heads, int d,
                                       int is_bf16, int causal, int q_offset, float scale,
                                       void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || kv_heads < 1 || heads % kv_heads != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define FLASH_CASE(D)                                                                     \
  case D:                                                                                 \
    return launch<D>(q, k, v, o, batch, sq, sk, heads, kv_heads, is_bf16, causal, q_offset, \
                     scale, st);
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
#undef FLASH_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
