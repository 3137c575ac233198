// Non-causal flash attention for Hopper (sm_90a), q/k/v/o in (B, T, H, D).
//
// Replaces the Pallas TPU kernel daft_tpu/ops/pallas_attention.py::flash_attention
// (body _attn_kernel). Same function: softmax(q k^T * D^-0.5) v per (batch, head),
// online softmax with the running max m, denominator l and accumulator kept in f32,
// keys at positions >= T masked to -1e30, output acc / max(l, 1e-30) in the input
// dtype.
//
// Bound at the main path's shape (CLIP ViT-L/14, B=128, T=257, H=16, D=64, bf16):
//   operations  4 * B * H * T^2 * D = 34.6 GFLOP  -> 35 us at 989 TFLOP/s (bf16 tensor cores)
//   bytes       q, k, v read once, o written once = 4 * 67.4 MB = 270 MB -> 80 us at 3.35 TB/s
// so a launch can take no less than ~80 us, and memory sets the bound. What the design
// does about it:
//   * q, k, v are read in place through their (B, T, H, D) strides: each is a 4-D TMA
//     tensor map (dims D, H, T, B) over the real strides, so the views into the fused
//     qkv projection are never copied, transposed or padded. TMA fills rows past T
//     with zeros; logits of keys >= T are masked.
//   * bf16: one thread block per (b, h, 128 query rows): two consumer warpgroups of
//     64 rows each. Thread 0 keeps TMA loads of 128-key K and V tiles in flight
//     through a ring of kStages stages, each with a full and an empty mbarrier; both
//     warpgroups read every stage, so a head's K and V pass through L2 ceil(T / 128)
//     times instead of once per 64-row tile. No warp is set aside as producer: with
//     8 warps a block keeps 128 registers a thread at 2 blocks per SM (a 9th warp
//     would cap them at 96).
//   * Both products run on wgmma: S = Q K^T (m64n128k16, Q and K from shared memory,
//     K-major) and O += P V (m64nDk16, P from registers, V from shared memory as it
//     lies in memory, N-major through the transposed-B bit). Tiles land in shared
//     memory with the 128-byte swizzle (64-byte at D=32) that the wgmma descriptors
//     name, so no thread moves or transposes a tile. The (T, T) logits never leave
//     registers; the softmax runs in base 2 with log2(e) folded into the scale.
//     128-key tiles halve the waits per key against 64-key ones, and S reads 6 KB
//     of shared memory per 64 cycles of tensor work instead of 4 KB per 32.
//   * The ragged last key tile: S is an m64n16k16 (m64n64k16) product and P V one
//     (four) k-steps when at most 16 (64) keys of it exist, so T = 257 pays for 272
//     keys instead of 384.
//   * f32 runs on the CUDA cores with f32 arithmetic throughout, so the f32 results
//     stay within 2e-5 of the f32 reference (TF32 would not). It is a parity path,
//     not the main path.
// PERF.md says what bounds the bf16 kernel now and what each of these choices was
// measured against: not the memory; the exp costs 8-13%; 20% of its query rows at
// T = 257 are padding.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's mask value
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;      // f32 path: 4 warps per block

// Return codes beside cudaError_t (whose values stay below 1000).
constexpr int kUnsupported = 1000;         // dtype or head dim the kernel does not take
constexpr int kNoTensorMapEncoder = 1001;  // cuTensorMapEncodeTiled cannot be found
constexpr int kTensorMapRejected = 1002;   // cuTensorMapEncodeTiled refused a layout

struct Strides {
  long long sb, st, sh;  // element strides of the B, T and H axes; D is contiguous
};

// ---------------------------------------------------------------------------
// f32: CUDA cores. A block holds 16 query rows (4 per warp); a K/V tile holds
// 32 keys, one per lane for Q.K^T, then the lanes split D for P.V.
// ---------------------------------------------------------------------------
constexpr int F32_BQ = 16;
constexpr int F32_BK = 32;
constexpr int F32_ROWS = F32_BQ / (kThreads / 32);

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int T, int H,
                Strides qs, Strides ks, Strides vs, float scale) {
  __shared__ float sq[F32_BQ][D];
  __shared__ float sk[F32_BK][D + 1];  // +1: lane j reads row j without bank conflicts
  __shared__ float sv[F32_BK][D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * F32_BQ;
  const float* qb = q + b * qs.sb + h * qs.sh;
  const float* kb = k + b * ks.sb + h * ks.sh;
  const float* vb = v + b * vs.sb + h * vs.sh;

  // (q * scale) first, then the product: the Pallas kernel's order.
  for (int i = tid; i < F32_BQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    sq[r][c] = t < T ? qb[t * qs.st + c] * scale : 0.f;
  }

  float m[F32_ROWS], l[F32_ROWS], acc[F32_ROWS][D / 32];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += F32_BK) {
    __syncthreads();  // the previous tile is consumed (and, first time, sq is written)
    for (int i = tid; i < F32_BK * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool ok = t < T;
      sk[r][c] = ok ? kb[t * ks.st + c] : 0.f;
      sv[r][c] = ok ? vb[t * vs.st + c] : 0.f;
    }
    __syncthreads();
    const bool key_ok = k0 + lane < T;
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) {
      const int row = warp * F32_ROWS + r;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(sq[row][c], sk[lane][c], s);
      if (!key_ok) s = kNegInf;
      float mt = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float p = expf(s - m_new);
      const float corr = expf(m[r] - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[r][c] *= corr;
#pragma unroll 4
      for (int j = 0; j < F32_BK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int c = 0; c < D / 32; ++c) acc[r][c] = fmaf(pj, sv[j][c * 32 + lane], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    const int t = q0 + warp * F32_ROWS + r;
    if (t >= T) continue;
    float* ob = o + ((static_cast<long long>(b) * T + t) * H + h) * D;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 32; ++c) ob[c * 32 + lane] = acc[r][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed K/V ring and wgmma. A block holds kConsumers * 64 query rows of
// one (b, h), one consumer warpgroup per 64 rows, and walks 128-key tiles.
// Thread 0 also issues every TMA load: no warp is set aside for it, so the
// block's 8 warps keep 128 registers each at 2 blocks per SM.
// ---------------------------------------------------------------------------
constexpr int kTile = 64;      // query rows per consumer warpgroup
constexpr int kKeys = 128;     // keys per K/V tile
constexpr int kConsumers = 2;  // consumer warpgroups per block
constexpr int kStages = 2;     // depth of the K/V ring
constexpr int kBf16Threads = kConsumers * 128;
constexpr float kLog2e = 1.4426950408889634f;

// A tile of `Rows` rows of q, k or v lands as D / 64 boxes (one at D = 32), each
// row of a box one swizzle span: 128 bytes (64 bytes at D = 32).
template <int D, int Rows>
struct TileShape {
  static constexpr int kRowBytes = (D < 64 ? D : 64) * 2;
  static constexpr int kBoxBytes = Rows * kRowBytes;
  static constexpr int kBytes = Rows * D * 2;
  static constexpr uint32_t kLayout = kRowBytes == 128 ? hopper::kSwizzle128B : hopper::kSwizzle64B;
};

template <int D>
struct Bf16Tiles {
  using Q = TileShape<D, kTile>;
  using KV = TileShape<D, kKeys>;
  // Q tiles, K ring, V ring, then the barriers; +1024 to align the base for the swizzle.
  static constexpr int kRingOffset = kConsumers * Q::kBytes;
  static constexpr int kBarrierOffset = kRingOffset + 2 * kStages * KV::kBytes;
  static constexpr int kSmemBytes = kBarrierOffset + (kConsumers + 3 * kStages) * 8 + 1024;
};

// Shared-memory addresses of a block's tiles and barriers. Key tile j lies in
// stage j % kStages; its barriers complete their phase (j / kStages) & 1.
template <int D>
struct Bf16Smem {
  using L = Bf16Tiles<D>;
  uint32_t base;  // 1024-byte aligned
  __device__ uint32_t q(int i) const { return base + i * L::Q::kBytes; }
  __device__ uint32_t k(int j) const {
    return base + L::kRingOffset + (j % kStages) * L::KV::kBytes;
  }
  __device__ uint32_t v(int j) const {
    return base + L::kRingOffset + (kStages + j % kStages) * L::KV::kBytes;
  }
  __device__ uint32_t q_full(int i) const { return base + L::kBarrierOffset + 8 * i; }
  __device__ uint32_t k_full(int j) const { return q_full(kConsumers + j % kStages); }
  __device__ uint32_t v_full(int j) const { return q_full(kConsumers + kStages + j % kStages); }
  __device__ uint32_t empty(int j) const { return q_full(kConsumers + 2 * kStages + j % kStages); }
  __device__ static uint32_t phase(int j) { return (j / kStages) & 1; }
};

// K-major operand (Q or K: rows of D contiguous), k-step kk = columns 16kk..16kk+15:
// 32 bytes further along the swizzled row, or into the next 64-column box.
template <class Shape>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  const int byte = kk * 32;
  const int offset = (byte / Shape::kRowBytes) * Shape::kBoxBytes + byte % Shape::kRowBytes;
  return hopper::make_desc(tile, 16, 8 * Shape::kRowBytes, Shape::kLayout) + (offset >> 4);
}

// N-major operand (V: keys x D with D contiguous), k-step kk = keys 16kk..16kk+15.
// Groups of 8 keys lie 8 rows apart (SBO); the 64-column boxes of D = 128 lie one
// box apart (LBO).
template <class Shape>
__device__ __forceinline__ uint64_t desc_n_major(uint32_t tile, int kk) {
  return hopper::make_desc(tile, Shape::kBoxBytes, 8 * Shape::kRowBytes, Shape::kLayout) +
         ((kk * 16 * Shape::kRowBytes) >> 4);
}

template <class Shape>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                          int h, int t0, int b, int leader) {
  hopper::mbar_arrive_expect_tx(bar, Shape::kBytes, leader);
#pragma unroll
  for (int box = 0; box < Shape::kBytes / Shape::kBoxBytes; ++box)
    hopper::tma_load_4d(map, dst + box * Shape::kBoxBytes, bar, box * (Shape::kRowBytes / 2), h,
                        t0, b, leader);
}

// What a consumer warpgroup needs to walk the key tiles and keep the ring full.
template <int D>
struct Walk {
  using KV = typename Bf16Tiles<D>::KV;
  Bf16Smem<D> sm;
  const CUtensorMap *tk, *tv;
  int h, b, n_kv;
  int leader;  // 1 in thread 0, which issues the loads
  __device__ void load(int j) const {
    load_tile<KV>(tk, sm.k(j), sm.k_full(j), h, j * kKeys, b, leader);
    load_tile<KV>(tv, sm.v(j), sm.v_full(j), h, j * kKeys, b, leader);
  }
  // Tile j is done with: release its stage; once both warpgroups have released
  // it, the stage takes tile j + kStages. Every consumer thread waits for that
  // (the two warpgroups run in step, so the wait is short); only the leader's
  // loads take effect.
  __device__ void release(int j) const {
    hopper::mbar_arrive(sm.empty(j));
    if (j + kStages < n_kv) {
      hopper::mbar_wait(sm.empty(j), sm.phase(j));
      load(j + kStages);
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// The pieces of one key tile for one consumer warpgroup. S holds N keys: 128, or
// 64 or 16 for a last tile of at most that many keys. Thread layout of S and O:
// rows g and g + 8 of this warp's 16, where g = lane / 4; columns
// 8c + 2 * (lane % 4) + {0, 1} of each 8-column chunk c.

// Issues S = Q K^T as one wgmma group.
template <int D, int N>
__device__ __forceinline__ void issue_qk(float (&s)[N / 2], uint32_t q_tile, uint32_t k_tile) {
  using L = Bf16Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<N>(s, desc_k_major<typename L::Q>(q_tile, kk),
                        desc_k_major<typename L::KV>(k_tile, kk), kk > 0);
  hopper::wgmma_commit();
}

// Issues O += P V over the N keys as one wgmma group.
template <int D, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&p)[N / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    hopper::wgmma_rs<D>(acc, p[kk], desc_n_major<typename Bf16Tiles<D>::KV>(v_tile, kk), 1);
  hopper::wgmma_commit();
}

// Online softmax of a finished S in place: masks keys past T (valid of the
// tile's keys exist), updates the running max m (log2 units) and this thread's
// share l of each row sum, and returns the factor corr that rescales O.
// p = exp(s * scale - max) = 2^(s * scale * log2(e) - m); the 4 lanes of a row
// add their shares of l up at the end.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int valid, float scale_log2,
                                               int t4) {
  float mt[2] = {kNegInf, kNegInf};
  const bool ragged = valid < N;
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ragged && 8 * c + 2 * t4 + (e & 1) >= valid) s[4 * c + e] = kNegInf;
      mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * c + e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // The 4 lanes of a group hold the same two rows.
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(kFull, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(kFull, mt[i], 2));
    const float m_new = fmaxf(m[i], mt[i] * scale_log2);
    corr[i] = hopper::exp2_approx(m[i] - m_new);
    m[i] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * c + e] = hopper::exp2_approx(fmaf(s[4 * c + e], scale_log2, -m[e >> 1]));
      rs[e >> 1] += s[4 * c + e];
    }
  }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], const float (&corr)[2]) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    acc[4 * c + 0] *= corr[0];
    acc[4 * c + 1] *= corr[0];
    acc[4 * c + 2] *= corr[1];
    acc[4 * c + 3] *= corr[1];
  }
}

// P in bf16: the S accumulators of 16 keys are exactly the register A fragment
// of one k-step of P V.
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N / 2], uint32_t (&p)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    p[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Key tile j for one consumer warpgroup: S = Q K^T, online softmax, O += P V,
// each product waited for before its registers are touched (the other
// warpgroups of the SM keep the tensor cores busy meanwhile); then the tile is
// released and the ring refilled.
template <int D, int N>
__device__ __forceinline__ void attend_tile(float (&acc)[D / 2], float (&m)[2], float (&l)[2],
                                            const Walk<D>& w, uint32_t q_tile, int j, int valid,
                                            float scale_log2, int t4) {
  const Bf16Smem<D>& sm = w.sm;
  float s[N / 2];
  float corr[2];
  uint32_t p[N / 16][4];
  hopper::mbar_wait(sm.k_full(j), sm.phase(j));
  hopper::wgmma_fence();
  issue_qk<D, N>(s, q_tile, sm.k(j));
  hopper::wgmma_wait<0>();
  hopper::reg_fence(s);
  online_softmax<N>(s, m, l, corr, valid, scale_log2, t4);
  rescale<D>(acc, corr);
  pack_p<N>(s, p);
  hopper::mbar_wait(sm.v_full(j), sm.phase(j));
  hopper::wgmma_fence();
  issue_pv<D, N>(acc, p, sm.v(j));
  hopper::wgmma_wait<0>();
  hopper::reg_fence(acc);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) hopper::reg_fence(p[kk]);
  w.release(j);
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, D <= 64 ? 2 : 1)
attn_bf16_tma_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int T,
                    int H, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const Bf16Smem<D> sm{(hopper::smem_u32(smem_raw) + 1023) & ~1023u};

  // The shuffle tells the compiler the warp index is uniform across the warp,
  // so the wgmma below are not on a divergent path.
  const int warp = __shfl_sync(kFull, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * (kConsumers * kTile);
  // Consumer warpgroups whose 64 rows start before T; a tile past T does nothing.
  const int active = min(kConsumers, (T - q0 + kTile - 1) / kTile);
  const int n_kv = (T + kKeys - 1) / kKeys;
  const Walk<D> w{sm, &tk, &tv, h, b, n_kv, threadIdx.x == 0};

  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers; ++i) hopper::mbar_init(sm.q_full(i), 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(sm.k_full(s), 1);
      hopper::mbar_init(sm.v_full(s), 1);
      hopper::mbar_init(sm.empty(s), 128 * active);  // every consumer thread arrives
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = warp / 4;
  if (wg >= active) return;
  // The leader starts the Q tiles and fills the ring.
  for (int i = 0; i < active; ++i)
    load_tile<typename Bf16Tiles<D>::Q>(&tq, sm.q(i), sm.q_full(i), h, q0 + i * kTile, b,
                                        w.leader);
  for (int j = 0; j < min(kStages, n_kv); ++j) w.load(j);

  const int g = lane / 4, t4 = lane % 4;
  const uint32_t q_tile = sm.q(wg);
  const int last_valid = T - (n_kv - 1) * kKeys;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running row maxima, in log2 units
  float l[2] = {0.f, 0.f};
  hopper::mbar_wait(sm.q_full(wg), 0);
  for (int j = 0; j + 1 < n_kv; ++j)
    attend_tile<D, kKeys>(acc, m, l, w, q_tile, j, kKeys, scale_log2, t4);
  if (last_valid <= 16)
    attend_tile<D, 16>(acc, m, l, w, q_tile, n_kv - 1, last_valid, scale_log2, t4);
  else if (last_valid <= 64)
    attend_tile<D, 64>(acc, m, l, w, q_tile, n_kv - 1, last_valid, scale_log2, t4);
  else
    attend_tile<D, kKeys>(acc, m, l, w, q_tile, n_kv - 1, last_valid, scale_log2, t4);

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  const int t0 = q0 + wg * kTile + (warp % 4) * 16 + g, t1 = t0 + 8;
  __nv_bfloat16* o0 = o + ((static_cast<long long>(b) * T + t0) * H + h) * D + 2 * t4;
  __nv_bfloat16* o1 = o0 + 8LL * H * D;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    if (t0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 0] * inv[0], acc[4 * c + 1] * inv[0]);
    if (t1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2] * inv[1], acc[4 * c + 3] * inv[1]);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time (no link against libcuda).
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The (B, T, H, D) bf16 tensor as a 4-D map with dims (D, H, T, B), its byte
// strides, and a box of `rows` rows of one head (64 columns of D at a time).
template <int D>
int encode_map(CUtensorMap* map, const void* ptr, int B, int T, int H, Strides s, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kNoTensorMapEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.sh) * 2,
                                 static_cast<cuuint64_t>(s.st) * 2,
                                 static_cast<cuuint64_t>(s.sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(TileShape<D, kTile>::kRowBytes / 2), 1,
                            static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      TileShape<D, kTile>::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapRejected;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int T, int H,
               Strides qs, Strides ks, Strides vs, float scale, cudaStream_t stream) {
  const dim3 grid((T + F32_BQ - 1) / F32_BQ, H, B);
  attn_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), T, H, qs, ks, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

// Lets attn_bf16_tma_wgmma<D> take its shared memory on the current device.
// Function attributes are per device: each device's success is kept, a failure
// is returned and asked again at the next launch.
template <int D>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(attn_bf16_tma_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Bf16Tiles<D>::kSmemBytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int T, int H,
                Strides qs, Strides ks, Strides vs, float scale, cudaStream_t stream) {
  constexpr int smem = Bf16Tiles<D>::kSmemBytes;
  const cudaError_t attr = allow_smem<D>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  int rc = encode_map<D>(&tq, q, B, T, H, qs, kTile);
  if (rc == 0) rc = encode_map<D>(&tk, k, B, T, H, ks, kKeys);
  if (rc == 0) rc = encode_map<D>(&tv, v, B, T, H, vs, kKeys);
  if (rc != 0) return rc;
  const dim3 grid((T + kConsumers * kTile - 1) / (kConsumers * kTile), H, B);
  attn_bf16_tma_wgmma<D><<<grid, kBf16Threads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), T, H, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, loaded through ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success), or one of the codes
// >= 1000 above. The caller has already checked shapes, strides and alignment.
extern "C" int daft_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                    void* o, int B, int T, int H, int D, long long q_sb,
                                    long long q_st, long long q_sh, long long k_sb,
                                    long long k_st, long long k_sh, long long v_sb,
                                    long long v_st, long long v_sh, float scale,
                                    void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, o, B, T, H, qs, ks, vs, scale, s);
      case 64: return launch_f32<64>(q, k, v, o, B, T, H, qs, ks, vs, scale, s);
      case 128: return launch_f32<128>(q, k, v, o, B, T, H, qs, ks, vs, scale, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(q, k, v, o, B, T, H, qs, ks, vs, scale, s);
      case 64: return launch_bf16<64>(q, k, v, o, B, T, H, qs, ks, vs, scale, s);
      case 128: return launch_bf16<128>(q, k, v, o, B, T, H, qs, ks, vs, scale, s);
    }
  }
  return kUnsupported;
}

extern "C" const char* daft_cuda_error_string(int code) {
  switch (code) {
    case kUnsupported: return "unsupported dtype or head dim";
    case kNoTensorMapEncoder: return "cuTensorMapEncodeTiled cannot be found";
    case kTensorMapRejected: return "cuTensorMapEncodeTiled rejected the tensor layout";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
