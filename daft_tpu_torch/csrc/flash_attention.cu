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
//   * q, k, v are read in place through their (B, T, H, D) strides. There is no
//     transpose to (B*H, T, D) and no padding of T to a tile multiple (the TPU
//     version's three copies would each move another 67 MB); the ragged edge is
//     masked by bounds instead.
//   * One thread block per (b, h, 64-query tile); a loop over 64-key tiles inside the
//     block takes the place of the TPU grid's sequential kv axis. Each block reads
//     its Q tile once and keeps it in registers; the (T, T) logits never leave
//     registers, so the traffic is q, k, v, o plus K/V re-reads that L2 absorbs.
//   * bf16 runs both products on the tensor cores with mma.sync m16n8k16 (f32
//     accumulation). P is rounded to bf16 for the P.V product, as FlashAttention-2
//     does; the row sums l stay in f32.
//   * f32 runs on the CUDA cores with f32 arithmetic throughout, so the f32 results
//     stay within 2e-5 of the f32 reference (TF32 would not). It is a parity path,
//     not the main path.
// Not done yet (later work): cp.async/TMA double buffering of the K/V tiles, wgmma,
// warp specialisation, ldmatrix loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's mask value
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;      // 4 warps per block, both paths

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
// bf16: tensor cores through mma.sync m16n8k16. A block holds 64 query rows
// (16 per warp) and walks 64-key tiles. Fragments are read from shared memory
// as 32-bit words; rows are padded by 8 elements so those reads are free of
// bank conflicts. V is stored transposed so its B fragments are word reads too.
// ---------------------------------------------------------------------------
constexpr int BQ = 64;
constexpr int BK = 64;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
constexpr int bf16_smem_bytes() {
  return ((BQ + BK) * (D + 8) + D * (BK + 8)) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int T,
                 int H, Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int LDS = D + 8;   // row stride of sq and sk (elements)
  constexpr int LDV = BK + 8;  // row stride of the transposed svt
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int KD = D / 16;   // k-steps over D
  constexpr int NT = BK / 8;   // n-tiles of S per key tile
  constexpr int DT = D / 8;    // n-tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LDS
  __nv_bfloat16* sk = sq + BQ * LDS;                               // BK x LDS
  __nv_bfloat16* svt = sk + BK * LDS;                              // D x LDV

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group / thread in group
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + b * qs.sb + h * qs.sh;
  const __nv_bfloat16* kb = k + b * ks.sb + h * ks.sh;
  const __nv_bfloat16* vb = v + b * vs.sb + h * vs.sh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8, t = q0 + r;
    const uint4 val = t < T ? *reinterpret_cast<const uint4*>(qb + t * qs.st + c) : zero;
    *reinterpret_cast<uint4*>(sq + r * LDS + c) = val;
  }
  __syncthreads();

  // This warp's 16 query rows as A fragments, held for the whole key loop.
  const int wr = warp * 16;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const __nv_bfloat16* p = sq + (wr + g) * LDS + kk * 16 + tg * 2;
    qf[kk][0] = ld_u32(p);
    qf[kk][1] = ld_u32(p + 8 * LDS);
    qf[kk][2] = ld_u32(p + 8);
    qf[kk][3] = ld_u32(p + 8 * LDS + 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  // Index 0: row g of the warp's tile; index 1: row g + 8.
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8, t = k0 + r;
      uint4 kv = zero, vv = zero;
      if (t < T) {
        kv = *reinterpret_cast<const uint4*>(kb + t * ks.st + c);
        vv = *reinterpret_cast<const uint4*>(vb + t * vs.st + c);
      }
      *reinterpret_cast<uint4*>(sk + r * LDS + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) svt[(c + e) * LDV + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T over this key tile: 16 rows x BK keys per warp.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* p = sk + (nt * 8 + g) * LDS + kk * 16 + tg * 2;
        mma_16816(s[nt], qf[kk], ld_u32(p), ld_u32(p + 8));
      }
    }

    // Scale, mask keys past T, and take the tile's row maxima.
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tg * 2 + (e & 1);
        s[nt][e] = key < T ? s[nt][e] * scale : kNegInf;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The 4 lanes of a group hold the same two rows.
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(kFull, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(kFull, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(kFull, rs[i], 1);
      rs[i] += __shfl_xor_sync(kFull, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V. The S accumulators of two neighbouring n-tiles are exactly the
    // A fragment of one 16-key k-step.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* p = svt + (dt * 8 + g) * LDV + kk * 16 + tg * 2;
        mma_16816(acc[dt], a, ld_u32(p), ld_u32(p + 8));
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  const int t0 = q0 + wr + g, t1 = t0 + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (t0 < T) {
      __nv_bfloat16* ob = o + ((static_cast<long long>(b) * T + t0) * H + h) * D + c;
      *reinterpret_cast<__nv_bfloat162*>(ob) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (t1 < T) {
      __nv_bfloat16* ob = o + ((static_cast<long long>(b) * T + t1) * H + h) * D + c;
      *reinterpret_cast<__nv_bfloat162*>(ob) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int T,
                       int H, Strides qs, Strides ks, Strides vs, float scale,
                       cudaStream_t stream) {
  const dim3 grid((T + F32_BQ - 1) / F32_BQ, H, B);
  attn_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), T, H, qs, ks, vs, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int T,
                        int H, Strides qs, Strides ks, Strides vs, float scale,
                        cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  attn_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, H, qs, ks,
      vs, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded through ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success); 1000 for an unsupported
// dtype or head dim. The caller has already checked shapes, strides and alignment.
extern "C" int daft_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                    void* o, int B, int T, int H, int D, long long q_sb,
                                    long long q_st, long long q_sh, long long k_sb,
                                    long long k_st, long long k_sh, long long v_sb,
                                    long long v_st, long long v_sh, float scale,
                                    void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    switch (D) {
      case 32: err = launch_f32<32>(q, k, v, o, B, T, H, qs, ks, vs, scale, s); break;
      case 64: err = launch_f32<64>(q, k, v, o, B, T, H, qs, ks, vs, scale, s); break;
      case 128: err = launch_f32<128>(q, k, v, o, B, T, H, qs, ks, vs, scale, s); break;
      default: return 1000;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: err = launch_bf16<32>(q, k, v, o, B, T, H, qs, ks, vs, scale, s); break;
      case 64: err = launch_bf16<64>(q, k, v, o, B, T, H, qs, ks, vs, scale, s); break;
      case 128: err = launch_bf16<128>(q, k, v, o, B, T, H, qs, ks, vs, scale, s); break;
      default: return 1000;
    }
  } else {
    return 1000;
  }
  return static_cast<int>(err);
}

extern "C" const char* daft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
