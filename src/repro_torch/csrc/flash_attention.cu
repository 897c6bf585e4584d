// flash_prefill: forward attention with GQA, causal and/or sliding-window
// masks and logit softcap, for prefill.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py, body _flash_kernel).  It computes
// the same function: softmax(mask(softcap(scale * q k^T))) v with an f32
// online softmax, output in the input type.  Three kernels serve it:
//   * bf16, hd 32 to 256 (multiples of 32): flash_prefill_wgmma_kernel, both
//     products on wgmma; the model paths run here;
//   * bf16, hd 16: flash_prefill_mma_kernel, both products on mma.sync (16
//     columns are half of the wgmma kernel's 32-column panel);
//   * f32: flash_prefill_f32_kernel, on the CUDA cores.
// q, k, v and the output are read and written in the model's (B, S, heads,
// hd) layout through strides; any S, Sq != Sk and causal=false work, and
// key tiles wholly above the diagonal or left of the window are never
// loaded (the Pallas grid visits every block and masks it).
//
// What bounds it on an H100: stablelm-12b's prefill call (B=4, S=512, H=32,
// K=8, hd=160, causal) needs 10.8 GFLOP and moves 52 MB, 15.6 us of memory
// at 3.35 TB/s against 10.9 us of bf16 tensor work; zamba2-1.2b's (B=4,
// S=1024, 32 heads of 64, MHA) 17.2 GFLOP and 67 MB, 20.0 us against
// 17.4 us.  Both are bound by bytes on paper; what holds the kernel back is
// latency: each block reads its Q tile from memory before its first
// product and writes its output after its last, and one exp per score runs
// on the special-function units (16 a cycle per SM) beside the products.
//
// What the bf16 designs do about it:
//   * GQA packing: a block owns one (batch, KV head) and a tile of query
//     positions; its 128 rows are the q_per_kv heads of the group times
//     128 / q_per_kv positions, so each K/V tile in shared memory feeds
//     every head of the group (the TPU kernel fetches K/V per query head);
//   * the blocks whose position tiles see the most keys start first;
//   * scores live in the log2 domain (scale * log2 e folded into one
//     multiply, exp2), the softcap is a template flag, and only tiles that
//     straddle the diagonal, the window's edge or Sk evaluate masks, with
//     the reference's finite mask value;
//   * wgmma kernel: two warpgroups of 64 rows; S = Q K^T with Q and K from
//     shared memory, P from registers times V (the transpose bit) for
//     O += P V.  Q, K and V sit in 64-byte-swizzled panels of 32 columns,
//     one layout for every head size from 32 to 256 (hd 160 is five panels).
//     TMA fills a ring of K/V stages, one thread issuing the loads and an
//     mbarrier per stage counting their bytes, a second one the warps done
//     with it, so no block-wide barrier stands in the key loop.  Each
//     warpgroup keeps S = Q K^T of the next tile and O += P V of this one
//     in flight while the softmax runs, and rescales O only when a row's
//     maximum grew by more than 2^8.  Q arrives and O leaves by TMA (by the
//     threads where the layout does not allow a box), and each block brings
//     the Q tile of the block most likely to follow it on the card into L2;
//   * mma.sync kernel: eight warps of 16 rows, a 3-stage cp.async ring.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (tools/prefill_ab.py, all in one
// process, in turns): stablelm's call takes 0.0458-0.0460 ms, against
// 0.1366-0.1368 ms for the first mma.sync kernel (one 64-row block per
// query head) and 0.0459-0.0463 ms for scaled_dot_product_attention;
// zamba2's 0.0631-0.0634 ms against 0.2145 and 0.0589-0.0590 ms.
//
// Rows with no valid key are outside the contract: the reference returns
// the mean of all of V there; these kernels return 0 or the mean of V over
// the key slots they visited (slots past Sk count as zero vectors).

#include <cstdint>

#include <cudaTypedefs.h>

#include "common.cuh"
#include "wgmma.cuh"

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
// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulate).  Eight warps
// of 16 packed query rows each (128 rows), 64-key tiles.  Each warp keeps its
// scores and output rows in registers in the mma accumulator layout; the
// score accumulators become the A operand of the PV product directly.
//
// GQA packing: a block owns one (batch, KV head) and a tile of query
// positions; packed row r is query head r % heads of that KV head's group at
// position q0 + r / heads, so every K/V tile in shared memory feeds all
// q_per_kv heads.  Rows past heads * positions (125 of 128 at q_per_kv 5,
// 120 at 12) hold no query and are never stored.
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;
constexpr int kMmaBK = 64;
constexpr size_t kSmemPerBlock = 232448;  // the H100's 227 KB opt-in limit
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr size_t mma_tile_bytes(int rows) {
  return sizeof(__nv_bfloat16) * rows * (HD + 8);  // padded rows, see LD below
}

// K/V stages in the cp.async ring: three where shared memory allows, else two.
template <int HD>
__host__ __device__ constexpr int mma_stages() {
  return mma_tile_bytes<HD>(kMmaRows) + 3 * 2 * mma_tile_bytes<HD>(kMmaBK) <= kSmemPerBlock
             ? 3
             : 2;
}

template <int HD>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return mma_tile_bytes<HD>(kMmaRows) + mma_stages<HD>() * 2 * mma_tile_bytes<HD>(kMmaBK);
}

// How the query rows of a KV head's group are packed into blocks.
struct Packing {
  int heads;      // query heads per block: min(q_per_kv, 128)
  int positions;  // query positions per block: 128 / heads
  int chunks;     // blocks over one group's heads (1 unless q_per_kv > 128)
  int tiles;      // position tiles: ceil(Sq / positions)
  int K, B;
  int resident;   // blocks the card holds at once (read by the wgmma kernel)
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Starts copying keys [k0, k0 + 64) of a (keys, HD) K or V tile into shared
// memory with 16-byte cp.async; keys at or past `limit` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_kv_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              long long row_stride, int k0, int limit) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < kMmaBK * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const bool valid = k0 + r < limit;
    cp_async_16(dst + r * (HD + 8) + c, valid ? src + (k0 + r) * row_stride + c : src, valid);
  }
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(kMmaThreads, HD <= 64 ? 2 : 1)
    flash_prefill_mma_kernel(PrefillArgs a, Packing p) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = HD + 8;  // padded rows: the 8 rows of an ldmatrix hit distinct banks
  constexpr int NS = kMmaBK / 8;  // score n-tiles
  constexpr int NO = HD / 8;      // output n-tiles
  constexpr int NST = mma_stages<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kMmaRows * LD;
  bf16* Vs = Ks + NST * kMmaBK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // Longest work first: under a causal mask the last position tiles see the
  // most keys, and they take the lowest block indices.
  const int per_tile = p.chunks * p.K * p.B;
  const int tile = p.tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int chunk = rest % p.chunks;
  rest /= p.chunks;
  const int kh = rest % p.K, b = rest / p.K;
  const int q0 = tile * p.positions;
  const int nh = min(p.heads, a.q_per_kv - chunk * p.heads);  // heads this block serves
  const int h0 = kh * a.q_per_kv + chunk * p.heads;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h0 * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + kh * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + kh * a.vsh;
  // The causal limit of a row depends on its position only: the block's
  // keys end at its last position's.
  const int q_last = min(q0 + p.positions, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int n_tiles = k_begin < k_end ? (k_end - k_begin + kMmaBK - 1) / kMmaBK : 0;

  // The Q tile and the first NST - 1 K/V tiles are all requested before any
  // wait; the Q tile rides in the first group.
  for (int i = threadIdx.x; i < kMmaRows * (HD / 8); i += kMmaThreads) {
    const int r = i / (HD / 8), c = (i - r * (HD / 8)) * 8;
    const int pr = r / p.heads, j = r - pr * p.heads, qp = q0 + pr;
    const bool valid = pr < p.positions && j < nh && qp < a.Sq;
    cp_async_16(Qs + r * LD + c, valid ? qb + qp * a.qss + j * a.qsh + c : qb, valid);
  }
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) {
      load_kv_async<HD>(Ks + s * kMmaBK * LD, kb, a.kss, k_begin + s * kMmaBK, a.Sk);
      load_kv_async<HD>(Vs + s * kMmaBK * LD, vb, a.vss, k_begin + s * kMmaBK, a.Sk);
    }
    cp_async_commit();
  }

  // This lane's two rows (g and g + 8 of the warp's 16) and the positions
  // the warp's rows span.
  const int row0 = warp * 16 + g, row1 = row0 + 8;
  const int pr0 = row0 / p.heads, pr1 = row1 / p.heads;
  const int qp0 = q0 + pr0, qp1 = q0 + pr1;
  const int j0 = row0 - pr0 * p.heads, j1 = row1 - pr1 * p.heads;
  const int w_first = q0 + warp * 16 / p.heads;
  const int w_last = min(q0 + min((warp * 16 + 15) / p.heads, p.positions - 1), a.Sq - 1);
  const bool w_idle = warp * 16 / p.heads >= p.positions || w_first > w_last;
  const float scale_l2 = CAP ? a.scale / a.cap : a.scale * kLog2e;
  const float cap_l2 = a.cap * kLog2e;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0, stage = 0; it < n_tiles; ++it, stage = stage + 1 == NST ? 0 : stage + 1) {
    cp_async_wait<NST - 2>();  // tile `it` (and the Q tile) have landed
    __syncthreads();           // ... for every thread; and tile it - 1 is consumed
    {
      const int nxt = it + NST - 1;
      const int ns = stage == 0 ? NST - 1 : stage - 1;  // the stage tile it - 1 used
      if (nxt < n_tiles) {
        load_kv_async<HD>(Ks + ns * kMmaBK * LD, kb, a.kss, k_begin + nxt * kMmaBK, a.Sk);
        load_kv_async<HD>(Vs + ns * kMmaBK * LD, vb, a.vss, k_begin + nxt * kMmaBK, a.Sk);
      }
      cp_async_commit();
    }
    const int k0 = k_begin + it * kMmaBK;
    // A tile wholly masked for this warp's rows adds nothing: skip its math.
    if (w_idle || (a.causal && k0 > w_last) ||
        (a.window > 0 && k0 + kMmaBK - 1 <= w_first - a.window))
      continue;
    // Only a tile that straddles the diagonal, the window's edge or Sk needs
    // the per-score compares.
    const bool edge = k0 + kMmaBK > a.Sk || (a.causal && k0 + kMmaBK - 1 > w_first) ||
                      (a.window > 0 && w_last - k0 >= a.window);
    const bf16* Kt = Ks + stage * kMmaBK * LD;
    const bf16* Vt = Vs + stage * kMmaBK * LD;

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

    // Scores in the log2 domain: scale * log2(e) folded into one multiply,
    // or cap * log2(e) * tanh(scale * s / cap) with the softcap.
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = CAP ? cap_l2 * tanhf(s[n][e] * scale_l2) : s[n][e] * scale_l2;
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? qp0 : qp1;
          const int kp = k0 + n * 8 + 2 * t + (e & 1);
          const bool ok = kp < a.Sk && (!a.causal || r >= kp) &&
                          (a.window <= 0 || r - kp < a.window);
          if (!ok) s[n][e] = kMask;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // The four lanes of a quad hold one row's 64 scores between them.
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2_approx(m0 - mn0), al1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = exp2_approx(s[n][0] - mn0);
      s[n][1] = exp2_approx(s[n][1] - mn0);
      s[n][2] = exp2_approx(s[n][2] - mn1);
      s[n][3] = exp2_approx(s[n][3] - mn1);
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
  bf16* ob = static_cast<bf16*>(a.o) + b * a.osb + h0 * a.osh;
  const bool st0 = pr0 < p.positions && j0 < nh && qp0 < a.Sq;
  const bool st1 = pr1 < p.positions && j1 < nh && qp1 < a.Sq;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + 2 * t;
    if (st0)
      *reinterpret_cast<__nv_bfloat162*>(ob + qp0 * a.oss + j0 * a.osh + d) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (st1)
      *reinterpret_cast<__nv_bfloat162*>(ob + qp1 * a.oss + j1 * a.osh + d) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// The packing of a call: query heads and positions per block, blocks per
// group, position tiles.
Packing pack(const PrefillArgs& a, int B, int K) {
  Packing p;
  p.heads = a.q_per_kv < kMmaRows ? a.q_per_kv : kMmaRows;
  p.positions = kMmaRows / p.heads;
  p.chunks = (a.q_per_kv + p.heads - 1) / p.heads;
  p.tiles = (a.Sq + p.positions - 1) / p.positions;
  p.K = K;
  p.B = B;
  p.resident = 0;
  return p;
}

// Launches a kernel of the packed schedule, one block per position tile,
// group chunk, KV head and batch row.
template <typename Kernel>
cudaError_t launch_packed(Kernel kernel, size_t smem, int threads, const PrefillArgs& a, int B,
                          int K, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const Packing p = pack(a, B, K);
  const long long blocks = static_cast<long long>(p.tiles) * p.chunks * K * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(a, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on wgmma, head sizes 32 to 256 (multiples of 32).  The packing and
// the order of blocks are those of the mma.sync kernel above; two
// warpgroups of 64 packed rows each take the place of its eight warps.
//   * S = Q K^T is one m64nBKk16 product per 16 columns of hd, Q and K both
//     read from shared memory;
//   * the online softmax runs on S in registers;
//   * P, packed to bf16 in registers, is the A operand of O += P V, one
//     m64nHDk16 product per 16 keys, V read from shared memory with the
//     transpose bit (it is keys x hd, MN-major);
//   * K/V tiles arrive by TMA into a ring of stages, one thread issuing the
//     loads and an mbarrier per stage counting their bytes; a second
//     mbarrier per stage counts the warps done with it.  So no block-wide
//     barrier stands in the key loop, and while one warpgroup runs its
//     softmax the other's products keep the tensor cores busy.
// Q, K and V tiles are stored as 64-byte-swizzled 32-column panels
// (wgmma.cuh).
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 256;

// Keys per tile: 128 at hd 128; 64 elsewhere, where the accumulators of O,
// S and P leave no room for more (hd 160, 256), or where 64 keeps a block's
// registers and shared memory small enough for more blocks to share an SM
// (hd 32, 64).
template <int HD>
__host__ __device__ constexpr int wg_bk() {
  return HD == 128 ? 128 : 64;
}

template <int HD>
__host__ __device__ constexpr size_t wg_tile_bytes(int rows) {
  return sizeof(__nv_bfloat16) * rows * HD;
}

// Bytes of a block beyond its K/V ring: slack to start the tiles on a
// 1024-byte boundary, the Q tile, two mbarriers per stage (of at most four)
// and one for the Q tile.
template <int HD>
__host__ __device__ constexpr size_t wg_fixed_bytes() {
  return 1024 + wg_tile_bytes<HD>(kMmaRows) + 8 * (2 * 4 + 1);
}

// Stages in the K/V ring: up to four, as shared memory allows.
template <int HD>
__host__ __device__ constexpr int wg_stages() {
  return wg_fixed_bytes<HD>() + 4 * 2 * wg_tile_bytes<HD>(wg_bk<HD>()) <= kSmemPerBlock   ? 4
         : wg_fixed_bytes<HD>() + 3 * 2 * wg_tile_bytes<HD>(wg_bk<HD>()) <= kSmemPerBlock ? 3
                                                                                          : 2;
}

template <int HD>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return wg_fixed_bytes<HD>() + wg_stages<HD>() * 2 * wg_tile_bytes<HD>(wg_bk<HD>());
}

// The kernel's TMA tensor maps.  In the K and V maps the middle two
// dimensions are (heads, keys) or (keys, heads), whichever has the smaller
// stride first.  The Q and O maps, used where q_load and o_store are set,
// move the block's packed rows in one box per 32-column panel: (32 columns,
// heads, positions), which needs the heads dimension inside the positions
// one and one block per group; elsewhere the threads move Q and O.
struct TileMaps {
  CUtensorMap k, v, q, o;
  int k_heads_inner, v_heads_inner, q_load, o_store;
};

// Two blocks per SM where shared memory allows (the registers are then
// capped at 128 a thread).
template <int HD>
__host__ __device__ constexpr int wg_min_blocks() {
  return wg_smem_bytes<HD>() <= kSmemPerBlock / 2 ? 2 : 1;
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(kWgThreads, wg_min_blocks<HD>())
    flash_prefill_wgmma_kernel(PrefillArgs a, Packing p, const __grid_constant__ TileMaps maps) {
  using bf16 = __nv_bfloat16;
  static_assert(HD % 32 == 0, "wgmma tiles are 32-column panels");
  constexpr int BK = wg_bk<HD>();
  constexpr int NS = BK / 8;   // score n-blocks of 8 keys
  constexpr int NP = HD / 32;  // 32-column panels
  constexpr int NST = wg_stages<HD>();
  constexpr int R = kMmaRows;
  constexpr uint32_t kQPanel = R * 64, kKVPanel = BK * 64;  // bytes
  constexpr uint32_t kStageBytes = 2 * wg_tile_bytes<HD>(BK);      // K and V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  unsigned char* Qs = smem_raw + pad;
  unsigned char* Ks = Qs + wg_tile_bytes<HD>(R);
  unsigned char* Vs = Ks + NST * wg_tile_bytes<HD>(BK);
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + NST * wg_tile_bytes<HD>(BK));
  uint64_t* empty = full + NST;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = threadIdx.x >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int per_tile = p.chunks * p.K * p.B;
  const int tile = p.tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int chunk = rest % p.chunks;
  rest /= p.chunks;
  const int kh = rest % p.K, b = rest / p.K;
  const int q0 = tile * p.positions;
  const int nh = min(p.heads, a.q_per_kv - chunk * p.heads);
  const int h0 = kh * a.q_per_kv + chunk * p.heads;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h0 * a.qsh;
  const int q_last = min(q0 + p.positions, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int n_tiles = k_begin < k_end ? (k_end - k_begin + BK - 1) / BK : 0;

  // One thread fills the ring: K and V of tile i into stage i % NST, each
  // panel one TMA box; keys past Sk arrive as zeros.
  auto fill = [&](int i, int st) {
    const int k0 = k_begin + i * BK;
    mbar_arrive_expect_tx(&full[st], kStageBytes);
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      tma_load_4d(Ks + st * wg_tile_bytes<HD>(BK) + n * kKVPanel, &maps.k, &full[st], 32 * n,
                  maps.k_heads_inner ? kh : k0, maps.k_heads_inner ? k0 : kh, b);
      tma_load_4d(Vs + st * wg_tile_bytes<HD>(BK) + n * kKVPanel, &maps.v, &full[st], 32 * n,
                  maps.v_heads_inner ? kh : k0, maps.v_heads_inner ? k0 : kh, b);
    }
  };
  // The Q tile first, then the first NST K/V tiles, all in flight before
  // any wait.  Packed row r is at position r / heads: the float reciprocal
  // gives that quotient exactly for r < 256.
  const float inv_heads = 1.f / p.heads;
  auto position_of = [&](int r) { return __float2int_rz((r + 0.5f) * inv_heads); };
  uint64_t* q_full = empty + NST;
  const int q_rows = p.heads * p.positions;  // rows that hold a query
  if (maps.q_load) {
    // No TMA box covers the rows past q_rows: zero them.
    for (int i = threadIdx.x; i < (R - q_rows) * (HD / 8); i += kWgThreads)
      *reinterpret_cast<uint4*>(Qs + swizzled_offset(q_rows + i / (HD / 8), i % (HD / 8), R)) =
          make_uint4(0, 0, 0, 0);
  } else {
    for (int i = threadIdx.x; i < R * (HD / 8); i += kWgThreads) {
      const int r = i / (HD / 8), c = i - r * (HD / 8);
      const int pr = position_of(r), j = r - pr * p.heads, qp = q0 + pr;
      const bool valid = pr < p.positions && j < nh && qp < a.Sq;
      cp_async_16(Qs + swizzled_offset(r, c, R), valid ? qb + qp * a.qss + j * a.qsh + c * 8 : qb,
                  valid);
    }
    cp_async_commit();
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWgThreads / 32);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
    if (maps.q_load) {
      mbar_arrive_expect_tx(q_full, q_rows * HD * 2);
#pragma unroll
      for (int n = 0; n < NP; ++n)
        tma_load_4d(Qs + n * kQPanel, &maps.q, q_full, 32 * n, h0, q0, b);
    }
    for (int i = 0; i < NST && i < n_tiles; ++i) fill(i, i);
  }
  if (!maps.q_load) cp_async_wait<0>();
  fence_proxy_async();  // Q rows written by these threads are read by wgmma
  __syncthreads();      // ... and the barriers are set up
  if (maps.q_load) mbar_wait(q_full, 0);
  // Blocks start in index order as earlier ones finish: the block `resident`
  // places on is most likely next on some SM.  Bring its Q tile into L2
  // now, so that its first wait is short.
  if (threadIdx.x == 0 && maps.q_load && blockIdx.x + p.resident < gridDim.x) {
    const int nxt = static_cast<int>(blockIdx.x) + p.resident;
    const int n_rest = nxt % per_tile;  // chunks == 1 where q_load is set
    const int n_q0 = (p.tiles - 1 - nxt / per_tile) * p.positions;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      tma_prefetch_l2_4d(&maps.q, 32 * n, (n_rest % p.K) * a.q_per_kv, n_q0, n_rest / p.K);
  }

  // This thread's two rows, and the positions its warpgroup's rows span
  // (skips and masks are decided per warpgroup, which issues the products).
  const int row0 = warp * 16 + g, row1 = row0 + 8;
  const int pr0 = position_of(row0), pr1 = position_of(row1);
  const int qp0 = q0 + pr0, qp1 = q0 + pr1;
  const int g_first = q0 + wg * 64 / p.heads;
  const int g_last = min(q0 + min((wg * 64 + 63) / p.heads, p.positions - 1), a.Sq - 1);
  const bool g_idle = wg * 64 / p.heads >= p.positions || g_first > g_last;
  const float scale_l2 = CAP ? a.scale / a.cap : a.scale * kLog2e;
  const float cap_l2 = a.cap * kLog2e;
  const unsigned char* Qw = Qs + wg * 64 * 64;  // this warpgroup's 64 rows

  // Tile i waits for its K/V (acquire) and, once every warp is done with
  // it (release), its stage takes tile i + NST.
  auto acquire = [&](int i) { mbar_wait(&full[i % NST], (i / NST) & 1); };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % NST]);
    if (threadIdx.x == 0 && i + NST < n_tiles) {
      mbar_wait(&empty[i % NST], (i / NST) & 1);
      fill(i + NST, i % NST);
    }
  };
  // S = Q K^T for tile i: 16 columns of hd per product; the first
  // overwrites S.  Issued, not waited for.
  auto issue_qk = [&](int i, float (&s)[BK / 2]) {
    const unsigned char* Kt = Ks + (i % NST) * wg_tile_bytes<HD>(BK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 1) * 32;  // the second 16 columns of a panel
      wgmma_ss(s, wgmma_desc(Qw + (kk >> 1) * kQPanel + off, 16, 512),
               wgmma_desc(Kt + (kk >> 1) * kKVPanel + off, 16, 512), kk > 0);
    }
    wgmma_commit();
  };

  float o[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // The online softmax of tile i's scores S: updates the running max and
  // sum, returns the factors the output rows are rescaled by, and leaves P
  // (in f32) in place of S.
  auto softmax = [&](int i, float (&s)[BK / 2], float& al0, float& al1) {
    const int k0 = k_begin + i * BK;
    const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > g_first) ||
                      (a.window > 0 && g_last - k0 >= a.window);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e)
      s[e] = CAP ? cap_l2 * tanhf(s[e] * scale_l2) : s[e] * scale_l2;
    if (edge) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = (e & 2) ? qp1 : qp0;
        const int kp = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
        const bool ok = kp < a.Sk && (!a.causal || r >= kp) &&
                        (a.window <= 0 || r - kp < a.window);
        if (!ok) s[e] = kMask;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // The running max moves only when a score passes it by more than 8
    // (log2 units): P then stays below 2^8, O and the sum keep their scale,
    // and most tiles need no rescale.  The result is the same either way,
    // since O and the sum always share one reference.
    const float mn0 = mx0 > m0 + 8.f ? mx0 : m0, mn1 = mx1 > m1 + 8.f ? mx1 : m1;
    al0 = exp2_approx(m0 - mn0);
    al1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[4 * n] = exp2_approx(s[4 * n] - mn0);
      s[4 * n + 1] = exp2_approx(s[4 * n + 1] - mn0);
      s[4 * n + 2] = exp2_approx(s[4 * n + 2] - mn1);
      s[4 * n + 3] = exp2_approx(s[4 * n + 3] - mn1);
      sum0 += s[4 * n] + s[4 * n + 1];
      sum1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
  };
  // P, packed to bf16, in the A fragment layout of the PV product's k16
  // steps: the accumulator layout of S is that layout for keys 16 j ..
  // 16 j + 15.
  auto pack = [&](const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
      pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
  };

  // Tiles [it_lo, it_hi) hold keys that some row of this warpgroup sees;
  // the others are only waited for and released.
  int it_lo = 0, it_hi = 0;
  if (!g_idle) {
    it_hi = n_tiles;
    if (a.causal) it_hi = g_last < k_begin ? 0 : min(n_tiles, (g_last - k_begin) / BK + 1);
    if (a.window > 0 && g_first - a.window - BK + 1 - k_begin >= 0)
      it_lo = min(it_hi, (g_first - a.window - BK + 1 - k_begin) / BK + 1);
  }
  for (int i = 0; i < it_lo; ++i) {
    acquire(i);
    release(i);
  }
  if (it_lo < it_hi) {
    // Software pipeline: while O += P V of tile i runs on the tensor cores,
    // S = Q K^T of tile i + 1 is already issued and its softmax runs.  The
    // A fragments of P are written only once no product is in flight, and
    // the last tile is peeled off so that every commit in the loop is
    // unconditional: so the compiler keeps the products asynchronous.
    float s[BK / 2], al0, al1;
    uint32_t pa[BK / 16][4];
    auto issue_pv = [&](int i) {
      const unsigned char* Vt = Vs + (i % NST) * wg_tile_bytes<HD>(BK);
      wgmma_fence_operand(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs_mn(o, pa[j], wgmma_desc(Vt + j * 16 * 64, kKVPanel, 512));
      wgmma_commit();
    };
    acquire(it_lo);
    issue_qk(it_lo, s);
    wgmma_wait<0>();
    wgmma_fence_operand(s);
    softmax(it_lo, s, al0, al1);
    pack(s, pa);
    for (int i = it_lo; i + 1 < it_hi; ++i) {
      acquire(i + 1);
      issue_qk(i + 1, s);
      issue_pv(i);
      wgmma_wait<1>();  // S of tile i + 1 (committed first) is complete
      wgmma_fence_operand(s);
      softmax(i + 1, s, al0, al1);
      wgmma_wait<0>();
      wgmma_fence_operand(o);
      release(i);
      if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) o[e] *= (e & 2) ? al1 : al0;
      }
      pack(s, pa);
    }
    issue_pv(it_hi - 1);
    wgmma_wait<0>();
    wgmma_fence_operand(o);
    release(it_hi - 1);
  }
  for (int i = it_hi; i < n_tiles; ++i) {
    acquire(i);
    release(i);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f, inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
  // The output rows, normalised and in bf16, go to the block's Q tile
  // (which no product reads any more), in the same swizzled panels; then
  // TMA writes them out, or, where the O map cannot, each warpgroup its own
  // rows, 16 bytes a thread, a row's chunks on neighbouring threads.
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(Qs + swizzled_offset(row0, i, R) + 4 * t) =
        __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(Qs + swizzled_offset(row1, i, R) + 4 * t) =
        __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
  if (maps.o_store) {
    fence_proxy_async();  // the rows, written by this thread, are read by TMA
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int n = 0; n < NP; ++n) tma_store_4d(&maps.o, Qs + n * kQPanel, 32 * n, h0, q0, b);
      tma_store_commit_and_wait_read();
    }
    return;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
  bf16* ob = static_cast<bf16*>(a.o) + b * a.osb + h0 * a.osh;
  for (int i = threadIdx.x & 127; i < 64 * (HD / 8); i += 128) {
    const int r = wg * 64 + i / (HD / 8), c = i % (HD / 8);
    const int pr = position_of(r), j = r - pr * p.heads, qp = q0 + pr;
    if (pr < p.positions && j < nh && qp < a.Sq)
      *reinterpret_cast<uint4*>(ob + qp * a.oss + j * a.osh + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swizzled_offset(r, c, R));
  }
}

// Blocks of `kernel` the current device holds at once.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int* out) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *out = sms * per_sm;
  return err;
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// so that the library needs no link against libcuda.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }();
  return fn;
}

// A 4-d map of a (B, S, heads, hd) bf16 tensor in boxes of 32 columns by
// `heads_box` heads by `rows_box` positions, with the 64-byte swizzle; its
// middle dimensions ordered by stride.  Returns false if the encoder
// refuses it.
bool encode_map(CUtensorMap* map, int* heads_inner, const void* base, int HD, int S, int heads,
                int B, long long sb, long long ss, long long sh, int heads_box, int rows_box) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  *heads_inner = sh <= ss;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(*heads_inner ? heads : S),
                              static_cast<cuuint64_t>(*heads_inner ? S : heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * (*heads_inner ? sh : ss)),
                                 static_cast<cuuint64_t>(2 * (*heads_inner ? ss : sh)),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(*heads_inner ? heads_box : rows_box),
                             static_cast<cuuint32_t>(*heads_inner ? rows_box : heads_box), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 head sizes that are multiples of 32 run on wgmma; hd 16, half of a
// 32-column panel, runs on the mma.sync kernel.
template <int HD>
__host__ __device__ constexpr bool uses_wgmma() {
  return HD % 32 == 0;
}

template <int HD, bool CAP>
cudaError_t launch_bf16(const PrefillArgs& a, int B, int K, cudaStream_t stream) {
  if constexpr (uses_wgmma<HD>()) {
    static_assert(wg_smem_bytes<HD>() <= kSmemPerBlock, "wgmma tiles exceed shared memory");
    Packing p = pack(a, B, K);
    TileMaps maps;
    if (!encode_map(&maps.k, &maps.k_heads_inner, a.k, HD, a.Sk, K, B, a.ksb, a.kss, a.ksh, 1,
                    wg_bk<HD>()) ||
        !encode_map(&maps.v, &maps.v_heads_inner, a.v, HD, a.Sk, K, B, a.vsb, a.vss, a.vsh, 1,
                    wg_bk<HD>()))
      return cudaErrorInvalidValue;
    int q_heads_inner = 0, o_heads_inner = 0;
    maps.q_load = p.chunks == 1 &&
                  encode_map(&maps.q, &q_heads_inner, a.q, HD, a.Sq, K * a.q_per_kv, B, a.qsb,
                             a.qss, a.qsh, p.heads, p.positions) &&
                  q_heads_inner;
    maps.o_store = p.chunks == 1 &&
                   encode_map(&maps.o, &o_heads_inner, a.o, HD, a.Sq, K * a.q_per_kv, B, a.osb,
                              a.oss, a.osh, p.heads, p.positions) &&
                   o_heads_inner;
    const auto kernel = flash_prefill_wgmma_kernel<HD, CAP>;
    cudaError_t err = allow_smem(kernel, wg_smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    // Counted at the first launch; a hint only (a wrong count prefetches
    // another block's Q tile).
    static int resident = 0;
    if (resident == 0) {
      err = resident_blocks(kernel, kWgThreads, wg_smem_bytes<HD>(), &resident);
      if (err != cudaSuccess) return err;
    }
    p.resident = resident;
    const long long blocks = static_cast<long long>(p.tiles) * p.chunks * K * B;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<static_cast<unsigned>(blocks), kWgThreads, wg_smem_bytes<HD>(), stream>>>(a, p, maps);
    return cudaGetLastError();
  } else {
    static_assert(mma_smem_bytes<HD>() <= kSmemPerBlock, "mma tiles exceed shared memory");
    return launch_packed(flash_prefill_mma_kernel<HD, CAP>, mma_smem_bytes<HD>(), kMmaThreads,
                         a, B, K, stream);
  }
}

template <int HD>
cudaError_t launch(int dtype, const PrefillArgs& a, int B, int H, cudaStream_t stream) {
  if (dtype == kBFloat16) {
    const int K = H / a.q_per_kv;
    return a.cap > 0.f ? launch_bf16<HD, true>(a, B, K, stream)
                       : launch_bf16<HD, false>(a, B, K, stream);
  }
  if (dtype != kFloat32) return cudaErrorInvalidValue;
  constexpr size_t smem = prefill_smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_prefill_f32_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, H, B);
  flash_prefill_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
int smem_bytes(int dtype) {
  if (dtype != kBFloat16) return static_cast<int>(prefill_smem_bytes<HD>());
  return static_cast<int>(uses_wgmma<HD>() ? wg_smem_bytes<HD>() : mma_smem_bytes<HD>());
}

}  // namespace
}  // namespace repro

// q (B, Sq, H, hd), k and v (B, Sk, K, hd), o (B, Sq, H, hd), each with a
// unit stride in its last dimension and 16-byte aligned rows; strides are
// in elements.  window <= 0 and cap <= 0 disable the window and the
// softcap.  Returns a cudaError_t.
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

// Dynamic shared memory of the kernel that serves (dtype, hd), in bytes;
// -1 for a head size no kernel serves.
extern "C" int repro_flash_prefill_smem(int dtype, int hd) {
  using namespace repro;
  switch (hd) {
    case 16: return smem_bytes<16>(dtype);
    case 32: return smem_bytes<32>(dtype);
    case 64: return smem_bytes<64>(dtype);
    case 128: return smem_bytes<128>(dtype);
    case 160: return smem_bytes<160>(dtype);
    case 256: return smem_bytes<256>(dtype);
    default: return -1;
  }
}
