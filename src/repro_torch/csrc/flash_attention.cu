// flash_prefill: forward attention with GQA, causal and/or sliding-window
// masks and logit softcap, for prefill.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py, body _flash_kernel).  It computes
// the same function: softmax(mask(softcap(scale * q k^T))) v with an f32
// online softmax, output in the input type.
//
// What bounds it on an H100: at the prefill shapes of stablelm-12b
// (B=4, S=512, H=32, K=8, hd=160, causal, bf16) a layer needs ~10.7 GFLOP
// and moves ~52 MB, so the card's limit is its memory (~16 us at
// 3.35 TB/s, against ~11 us of tensor-core work).  To come near either,
// the two products must run on the tensor cores and the tile loads must
// overlap the math.
//
// What the design does about it:
//   * bf16 (the model's type) runs both products on the tensor cores
//     (mma.sync m16n8k16, f32 accumulate): four warps of 16 query rows each
//     keep scores and output rows in registers, and the score accumulators
//     feed the PV product without a trip through shared memory.  K/V tiles
//     are double-buffered with cp.async, so the next tile loads while this
//     one is used;
//   * f32 runs on the CUDA cores;
//   * one block per (q tile, query head, batch); a loop over key tiles
//     inside the block takes the place of the TPU's sequential key grid
//     dimension, so the running max, sum and output rows stay on chip;
//   * key tiles wholly above the diagonal or left of the window are never
//     loaded (the Pallas grid visits every block and masks it);
//   * q, k, v and the output are read and written in the model's
//     (B, S, heads, hd) layout through strides, so no transposes are made;
//   * the ragged edge (S not a multiple of the tile) is masked here, so any
//     S works, as do Sq != Sk and causal=false.
// Rows with no valid key are outside the contract (the reference returns the
// mean of V there, this kernel returns 0).

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

// f32 on the CUDA cores: each warp owns 4 query rows, so their scores,
// softmax and output rows never leave the warp and a tile costs two block
// barriers.
constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = (kThreads / 32) * kRowsPerWarp;  // 32 query rows
constexpr int kKeysPerLane = 2;
constexpr int kBK = 32 * kKeysPerLane;  // 64 keys

struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int q_per_kv, Sq, Sk;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  float scale, cap;
  int causal, window;
};

template <int HD>
constexpr size_t prefill_smem_bytes() {
  // Q [kBQ][HD], K [kBK][HD + 1], V [kBK][HD], P [kBQ][kBK], all f32.
  return sizeof(float) * (kBQ * HD + kBK * (HD + 1) + kBK * HD + kBQ * kBK);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_prefill_f32_kernel(PrefillArgs a) {
  constexpr int NC = (HD + 31) / 32;  // output columns per lane
  constexpr int KS = HD + 1;          // padded K row: lanes reading 32 keys hit 32 banks
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * HD;
  float* Vs = Ks + kBK * KS;
  float* Ps = Vs + kBK * HD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.q_per_kv;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + kh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + kh * a.vsh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD, qp = q0 + r;
    Qs[i] = qp < a.Sq ? qb[qp * a.qss + d] : 0.f;
  }

  // Keys any row of this tile may see: skip the rest without loading it.
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and the Q tile stored)
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i - j * HD, kp = k0 + j;
      const bool in = kp < k_end;
      Ks[j * KS + d] = in ? kb[kp * a.kss + d] : 0.f;
      Vs[j * HD + d] = in ? vb[kp * a.vss + d] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) s[rr][kk] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float kv[kKeysPerLane];
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) kv[kk] = Ks[(lane + 32 * kk) * KS + d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float qv = Qs[(warp * kRowsPerWarp + rr) * HD + d];
#pragma unroll
        for (int kk = 0; kk < kKeysPerLane; ++kk) s[rr][kk] = fmaf(qv, kv[kk], s[rr][kk]);
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr, qp = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const int kp = k0 + lane + 32 * kk;
        const bool ok = kp < a.Sk && (!a.causal || qp >= kp) &&
                        (a.window <= 0 || qp - kp < a.window);
        s[rr][kk] = ok ? score(s[rr][kk], a.scale, a.cap) : kMask;
        mx = fmaxf(mx, s[rr][kk]);
      }
      const float m_new = fmaxf(m[rr], warp_max(mx));
      const float alpha = __expf(m[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const float p = __expf(s[rr][kk] - m_new);
        Ps[r * kBK + lane + 32 * kk] = p;
        sum += p;
      }
      l[rr] = l[rr] * alpha + warp_sum(sum);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[rr][c] *= alpha;
    }
    __syncwarp();  // P rows are written and read by the warp that owns them

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < HD ? Vs[j * HD + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float p = Ps[(warp * kRowsPerWarp + rr) * kBK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[rr][c] = fmaf(p, vv[c], acc[rr][c]);
      }
    }
  }

  float* ob = static_cast<float*>(a.o) + b * a.osb + h * a.osh;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qp = q0 + warp * kRowsPerWarp + rr;
    if (qp >= a.Sq) continue;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) ob[qp * a.oss + d] = acc[rr][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulate).  Four warps,
// 16 query rows each (a 64-row q tile), 64-key tiles.  Each warp keeps its
// scores and output rows in registers in the mma accumulator layout; the
// score accumulators become the A operand of the PV product directly.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;
constexpr int kMmaBQ = 64;
constexpr int kMmaBK = 64;

template <int HD>
constexpr size_t mma_smem_bytes() {
  // Q, then two K and two V buffers (the next tile lands while this one is used).
  return sizeof(__nv_bfloat16) * (kMmaBQ + 4 * kMmaBK) * (HD + 8);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const auto addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying rows [r0, r0 + rows) of a (rows, HD) tile into shared
// memory with 16-byte cp.async; rows at or past `limit` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int r0, int rows,
                                                int limit) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const bool valid = r0 + r < limit;
    cp_async_16(dst + r * (HD + 8) + c, valid ? src + (r0 + r) * row_stride + c : src, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_prefill_mma_kernel(PrefillArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = HD + 8;  // padded rows: the 8 rows of an ldmatrix hit distinct banks
  constexpr int NS = kMmaBK / 8;  // score n-tiles
  constexpr int NO = HD / 8;      // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* K0 = Qs + kMmaBQ * LD;
  bf16* K1 = K0 + kMmaBK * LD;
  bf16* V0 = K1 + kMmaBK * LD;
  bf16* V1 = V0 + kMmaBK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMmaBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.q_per_kv;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + kh * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + kh * a.vsh;
  const int q_last = min(q0 + kMmaBQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  load_tile_async<HD>(Qs, qb, a.qss, q0, kMmaBQ, a.Sq);
  if (k_begin < k_end) {
    load_tile_async<HD>(K0, kb, a.kss, k_begin, kMmaBK, a.Sk);
    load_tile_async<HD>(V0, vb, a.vss, k_begin, kMmaBK, a.Sk);
  }
  cp_async_commit();
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int w_first = q0 + warp * 16, w_last = min(w_first + 15, a.Sq - 1);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = k_begin, it = 0; k0 < k_end; k0 += kMmaBK, ++it) {
    const bf16* Kt = it & 1 ? K1 : K0;
    const bf16* Vt = it & 1 ? V1 : V0;
    __syncthreads();  // every warp is done with the buffers the next tile goes to
    if (k0 + kMmaBK < k_end) {
      load_tile_async<HD>(it & 1 ? K0 : K1, kb, a.kss, k0 + kMmaBK, kMmaBK, a.Sk);
      load_tile_async<HD>(it & 1 ? V0 : V1, vb, a.vss, k0 + kMmaBK, kMmaBK, a.Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the tile just requested have landed
    __syncthreads();
    // A tile wholly masked for this warp's rows adds nothing: skip its math.
    if (w_last < w_first || (a.causal && k0 > w_last) ||
        (a.window > 0 && k0 + kMmaBK - 1 <= w_first - a.window))
      continue;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t qa[4];
      ldmatrix_x4(qa, Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk +
                          (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qa, kf[0], kf[1]);
        mma_bf16(s[n + 1], qa, kf[2], kf[3]);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? row0 : row1;
        const int kp = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = kp < a.Sk && (!a.causal || r >= kp) &&
                        (a.window <= 0 || r - kp < a.window);
        s[n][e] = ok ? score(s[n][e], a.scale, a.cap) : kMask;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // The four lanes of a quad hold one row's 64 scores between them.
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = __expf(s[n][0] - mn0);
      s[n][1] = __expf(s[n][1] - mn0);
      s[n][2] = __expf(s[n][2] - mn1);
      s[n][3] = __expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + sum0;  // this lane's share; the quad's shares are summed at the end
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f, inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
  bf16* ob = static_cast<bf16*>(a.o) + b * a.osb + h * a.osh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * a.oss + d) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * a.oss + d) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int HD>
cudaError_t launch(int dtype, const PrefillArgs& a, int B, int H, cudaStream_t stream) {
  if (dtype == kBFloat16) {
    constexpr size_t smem = mma_smem_bytes<HD>();
    cudaError_t err = allow_smem(flash_prefill_mma_kernel<HD>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + kMmaBQ - 1) / kMmaBQ, H, B);
    flash_prefill_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  if (dtype != kFloat32) return cudaErrorInvalidValue;
  constexpr size_t smem = prefill_smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_prefill_f32_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, H, B);
  flash_prefill_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q (B, Sq, H, hd), k and v (B, Sk, K, hd), o (B, Sq, H, hd), each with a
// unit stride in its last dimension and 16-byte aligned rows; strides are
// in elements.  window <= 0
// and cap <= 0 disable the window and the softcap.  Returns a cudaError_t.
extern "C" int repro_flash_prefill(int dtype, int hd, const void* q, const void* k,
                                   const void* v, void* o, int B, int H, int K, int Sq,
                                   int Sk, long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   long long osb, long long oss, long long osh,
                                   float scale, int causal, int window, float cap,
                                   void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  const PrefillArgs a{q,   k,   v,   o,   H / K, Sq,  Sk,    qsb,  qss,    qsh,    ksb,
                      kss, ksh, vsb, vss, vsh,   osb, oss,   osh,  scale,  cap,    causal,
                      window};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(dtype, a, B, H, st);
    case 32: return launch<32>(dtype, a, B, H, st);
    case 64: return launch<64>(dtype, a, B, H, st);
    case 128: return launch<128>(dtype, a, B, H, st);
    case 160: return launch<160>(dtype, a, B, H, st);
    case 256: return launch<256>(dtype, a, B, H, st);
    default: return cudaErrorInvalidValue;
  }
}
