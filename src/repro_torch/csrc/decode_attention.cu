// flash_decode: one-token GQA attention over a KV cache, for each decode step.
//
// Replaces the Pallas TPU kernel decode_attention_bkh
// (src/repro/kernels/decode_attention.py, body _decode_kernel).  It computes
// the same function: for each row b the new token's q_per_kv query heads of
// one KV head attend over the cache entries [max(0, len - window), len) with
// an f32 online softmax and optional logit softcap.
//
// What bounds it on an H100: the bytes of K and V that the rows' lengths
// cover.  At stablelm-12b's decode shapes (B=4, K=8, hd=160, len ~545, bf16)
// that is ~11.2 MB a layer, ~3.3 us at 3.35 TB/s; at zamba2-1.2b's (B=4,
// K=32, hd=64, len ~1057) ~34 MB, ~10 us.  The arithmetic is ~4 flop per
// byte, far below the card's balance point.  So the kernel has to keep
// enough loads in flight on every SM, and cost little beyond them.
//
// What the design does about it:
//   * one launch: the blocks that split one (batch, KV head) pair's keys
//     form a thread-block cluster (flash-decoding with the merge on chip).
//     Each block stores its split's softmax max, sum and unnormalised output
//     into the shared memory of the blocks that own each slice of the
//     output (distributed shared memory), meets them at one cluster barrier,
//     and merges and writes its own slice.  No scratch in device memory, no
//     second kernel.  The split plan (kernels/decode_attention.py, ``plan``)
//     takes the largest cluster of which the card holds the whole grid at
//     once: a block's fixed latency (its row's length, the first loads, the
//     merge) is paid once, not once a wave;
//   * a block serves a group of up to 8 of its KV head's query heads from
//     one read of each K/V tile, so the cache is read once per group (once
//     in all at the configs' q_per_kv);
//   * bf16: K and V stream through a 4-stage ring of bf16 tiles in shared
//     memory, filled by 16-byte cp.async, the next three tiles in flight
//     while one is consumed; the block's barrier at each stage is the only
//     one in the key loop;
//   * every warp is busy at any q_per_kv: the four warps split each tile's
//     keys, and both products run on mma.sync with the block's heads as the
//     rows (so MHA leaves rows of a tensor-core product empty, not threads
//     idle).  q, the softmax state, P and the f32 outputs stay in each
//     warp's registers; P enters PV as a bf16 high and low part, which keeps
//     the reference's f32 P.  The warps merge once, after the last tile;
//   * f32 keeps the first version's kernel (K and V staged as f32 in shared
//     memory, one thread per (head, key) and per (head, dim)) with the same
//     cluster merge;
//   * the cache is read in place in the model's (B, S, K, hd) layout through
//     strides; lengths are read from device memory, so the host never
//     waits; only [len - window, len) (local layers) or [0, len) is read, and
//     any cache length S works.
//   * a shard of a cache split along its sequence (a device mesh's rank
//     holds keys [offset, offset + S) of each row): lengths and the window
//     stay in global positions, and a block reads the part of the row's
//     global range [len - window, len) that falls in its shard.  With an
//     lse output, the block that writes a row's first output element of a
//     head also writes that head's log-sum-exp m + log l over the shard's
//     keys (from the cluster merge's max and sum), so that the ranks can
//     merge their partial outputs.  A row with no key in its shard gets
//     output 0 and log-sum-exp -inf (its weight in the merge is exactly 0).
// Rows with len == 0 are outside the contract of a whole cache (the
// reference returns the mean of V there, this kernel returns 0).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxCluster = 16;  // kernels/decode_attention.py MAX_CLUSTER
constexpr int kMaxHeads = 8;     // kernels/decode_attention.py MAX_HEADS

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  int q_per_kv, heads, groups, S, chunk;
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh;
  float scale, cap;
  int window;
  // A sequence shard: the global position of its first key, `offset` plus
  // offsets[b] where that is not null; and the (B, H) f32 log-sum-exp output
  // (null: not asked for) with its strides.
  const int* offsets;
  int offset;
  float* lse;
  long long lsb, lsh;
};

// Where a block sits: its split of the row's keys and its query heads.
struct Work {
  int b, kh, h0, nh, k_begin, k_stop;
};

__device__ __forceinline__ Work block_work(const DecodeArgs& a, int rank) {
  Work w;
  const int g = blockIdx.y % a.groups;
  w.kh = blockIdx.y / a.groups;
  w.b = blockIdx.z;
  w.h0 = w.kh * a.q_per_kv + g * a.heads;
  w.nh = min(a.heads, a.q_per_kv - g * a.heads);
  // The row's keys in global positions, [first, len), shifted into the
  // shard and cut to its [0, S); empty where the shard holds none of them.
  const int off = a.offset + (a.offsets != nullptr ? a.offsets[w.b] : 0);
  const int len = a.lengths[w.b];
  const int first = a.window > 0 ? max(0, len - a.window) : 0;
  const int stop = min(a.S, len - off);
  w.k_begin = max(0, first - off) + rank * a.chunk;
  w.k_stop = min(stop, w.k_begin + a.chunk);
  return w;
}

// Floats of a block's merge buffers: its slice of every rank's outputs,
// [cluster][ceil(nh * HD / cluster)], and every rank's max and sum
// [2][cluster][nh].
template <int HD>
__host__ __device__ constexpr int merge_floats(int heads) {
  return heads * HD + kMaxCluster + 2 * kMaxCluster * heads;
}

// Distributed shared memory may be written only once its block has started:
// every block arrives at a cluster barrier first thing and waits on it just
// before its first store to another block (by then the wait is over).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The blocks of a cluster each hold their split's max m[r] and sum l[r]
// for the block's nh heads in shared memory, and partial(e) gives its
// unnormalised output e = r * HD + d (an empty split: m = -inf, l = 0,
// output 0).  Rank q of cs owns the outputs [q * slice, (q + 1) * slice) of
// the nh * HD: every block stores its partial outputs straight into their
// owners' buffers `rx` and its max and sum into every block's, in
// distributed shared memory (stores do not wait for the far SM), then one
// cluster.sync() makes them visible, and each block merges and writes its
// slice from its own shared memory.  No block reads another's memory, so
// none has to wait for the others to leave.
template <typename T, int HD, typename Partial>
__device__ void cluster_merge(const DecodeArgs& a, const Work& wk, const float* m,
                              const float* l, Partial partial, float* rx) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = wk.nh * HD, slice = (n + cs - 1) / cs;
  float* rm = rx + cs * slice;  // [cs][nh]
  float* rl = rm + cs * wk.nh;  // [cs][nh]
  cluster_wait();  // every block of the cluster has started (see cluster_arrive_relaxed)
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int q = e / slice;
    *cluster.map_shared_rank(rx + rank * slice + e - q * slice, q) = partial(e);
  }
  for (int i = threadIdx.x; i < cs * wk.nh; i += blockDim.x) {
    const int q = i / wk.nh, r = i - q * wk.nh;
    *cluster.map_shared_rank(rm + rank * wk.nh + r, q) = m[r];
    *cluster.map_shared_rank(rl + rank * wk.nh + r, q) = l[r];
  }
  cluster.sync();  // every split's partial sums are in their owners' memory
  T* ob = static_cast<T*>(a.o) + wk.b * a.osb + wk.h0 * a.osh;
  for (int e = rank * slice + threadIdx.x; e < min(n, (rank + 1) * slice); e += blockDim.x) {
    const int r = e / HD, d = e - r * HD, j = e - rank * slice;
    // Unrolled to the largest cluster, so that the loads issue together.
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (s < cs) mx = fmaxf(mx, rm[s * wk.nh + r]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s >= cs) break;
      const float ms = rm[s * wk.nh + r];
      const float f = ms == -INFINITY ? 0.f : __expf(ms - mx);
      sum = fmaf(f, rl[s * wk.nh + r], sum);
      o = fmaf(f, rx[s * slice + j], o);
    }
    if (a.lse != nullptr && d == 0)
      a.lse[wk.b * a.lsb + (wk.h0 + r) * a.lsh] = sum > 0.f ? mx + logf(sum) : -INFINITY;
    ob[r * a.osh + d] = from_f32<T>(sum > 0.f ? o / sum : 0.f);
  }
}

// ---------------------------------------------------------------------------
// f32: the first version's kernel (K and V staged as f32 in shared memory),
// with the cluster merge.
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32Tile = 64;

template <int HD>
__host__ __device__ constexpr size_t f32_smem_bytes(int heads) {
  // q [nh][HD], K [tile][HD + 1], V [tile][HD], P [nh][tile], acc [nh][HD],
  // m, l, alpha [nh], the merge buffers, all f32.
  return sizeof(float) * (heads * HD + kF32Tile * (HD + 1) + kF32Tile * HD + heads * kF32Tile +
                          heads * HD + 3 * heads + merge_floats<HD>(heads));
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads) flash_decode_f32_kernel(DecodeArgs a) {
  constexpr int KS = HD + 1;  // padded K row: consecutive keys fall in distinct banks
  constexpr int N = Vec16<float>::N;
  constexpr int kChunks = HD / N;
  cluster_arrive_relaxed();
  const Work wk = block_work(a, static_cast<int>(cg::this_cluster().block_rank()));
  const int R = wk.nh;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + R * HD;
  float* Vs = Ks + kF32Tile * KS;
  float* Ps = Vs + kF32Tile * HD;
  float* acc = Ps + R * kF32Tile;
  float* m = acc + R * HD;
  float* l = m + R;
  float* alpha = l + R;
  float* rx = alpha + R;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = static_cast<const float*>(a.q) + wk.b * a.qsb + wk.h0 * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + wk.b * a.ksb + wk.kh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + wk.b * a.vsb + wk.kh * a.vsh;

  for (int i = tid; i < R * HD; i += kF32Threads) {
    const int r = i / HD, d = i - r * HD;
    Qs[i] = qb[r * a.qsh + d];
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kF32Threads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int k0 = wk.k_begin; k0 < wk.k_stop; k0 += kF32Tile) {
    __syncthreads();  // the previous tile is consumed (and q, m, l stored)
    for (int i = tid; i < kF32Tile * kChunks; i += kF32Threads) {
      const int j = i / kChunks, d = (i - j * kChunks) * N, kp = k0 + j;
      float kv[N], vv[N];
      if (kp < wk.k_stop) {
        Vec16<float>::load(kb + kp * a.kss + d, kv);
        Vec16<float>::load(vb + kp * a.vss + d, vv);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        Ks[j * KS + d + e] = kv[e];
        Vs[j * HD + d + e] = vv[e];
      }
    }
    __syncthreads();

    // Scores: one (head, key) pair per thread at a time; consecutive lanes
    // take consecutive keys, so the padded K rows fall in distinct banks.
    for (int i = tid; i < R * kF32Tile; i += kF32Threads) {
      const int r = i / kF32Tile, j = i - r * kF32Tile;
      const float* qr = Qs + r * HD;
      const float* kr = Ks + j * KS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      Ps[i] = k0 + j < wk.k_stop ? score(dot, a.scale, a.cap) : kMask;
    }
    __syncthreads();

    // Online softmax: one warp per head.
    for (int r = warp; r < R; r += kF32Warps) {
      float* pr = Ps + r * kF32Tile;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float al = __expf(m[r] - m_new);
        alpha[r] = al;
        l[r] = l[r] * al + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * HD; i += kF32Threads) {
      const int r = i / HD, d = i - r * HD;
      const float* pr = Ps + r * kF32Tile;
      float o = acc[i] * alpha[r];
#pragma unroll 8
      for (int j = 0; j < kF32Tile; ++j) o = fmaf(pr[j], Vs[j * HD + d], o);
      acc[i] = o;
    }
  }
  __syncthreads();
  cluster_merge<float, HD>(a, wk, m, l, [&](int e) { return acc[e]; }, rx);
}

// ---------------------------------------------------------------------------
// bf16: K and V through a ring of bf16 tiles in shared memory; the warps
// split each tile's keys.
// ---------------------------------------------------------------------------
constexpr int kRingThreads = 128;
constexpr int kRingWarps = kRingThreads / 32;
constexpr int kStages = 4;

// Keys per ring stage: 64 up to hd 64, else 32 (a stage of K and V is then
// 18 KB at hd 64 and 21 KB at hd 160, so a block's ring stays under 90 KB
// and two or three blocks fit on an SM).  kernels/decode_attention.py
// tile_keys states the same rule.
template <int HD>
__host__ __device__ constexpr int ring_tile() {
  return HD <= 64 ? 64 : 32;
}

// Padded bf16 row: the 8 rows an ldmatrix reads fall in distinct banks.
template <int HD>
__host__ __device__ constexpr int ring_ld() {
  return HD + 8;
}

template <int HD>
__host__ __device__ constexpr size_t ring_bytes() {
  return size_t(2) * kStages * ring_tile<HD>() * ring_ld<HD>() * sizeof(bf16);
}

template <int HD>
__host__ __device__ constexpr size_t bf16_smem_bytes(int heads) {
  // The ring (after the key loop it holds the warps' outputs [warps][nh][HD],
  // f32), then f32 per warp its max, sum and merge weight [nh], the block's
  // max and sum [nh] and the merge buffers (apart from the ring: other
  // blocks store into them while this one may still be in its key loop).
  return ring_bytes<HD>() +
         sizeof(float) * (3 * kRingWarps * heads + 2 * heads + merge_floats<HD>(heads));
}

// Starts copying keys [k0, k0 + tile) of a K or V tile into a ring stage
// with 16-byte cp.async; keys at or past `stop` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_stage(bf16* dst, const bf16* src, long long row_stride,
                                           int k0, int stop) {
  constexpr int kChunks = HD / 8;
  constexpr int TK = ring_tile<HD>();
  for (int i = threadIdx.x; i < TK * kChunks; i += kRingThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const bool valid = k0 + r < stop;
    cp_async_16(dst + r * ring_ld<HD>() + c, valid ? src + (k0 + r) * row_stride + c : src,
                valid);
  }
}

// Each warp takes WK = tile / 4 keys of every tile, and both products run
// on mma.sync m16n8k16 with the block's heads as the rows (rows 8-15 zero).
// Scores: S = Q Kᵀ, the warp's keys as n-tiles of 8; q lives in registers
// as A fragments, K as B fragments straight from the ring by ldmatrix.  A
// lane then holds head g = lane / 4's scores for keys 2 (lane % 4) + {0, 1}
// of each n-tile, and that head's running max (the quad's lanes agree) and
// a share of its sum.  Those scores' exps are the A fragment of O += P V
// (the warp's keys as one k-step of 16, padded with zeros at 8 keys), V's B
// fragments come from the ring by ldmatrix.trans, and O stays in registers
// in the accumulator layout, so P, alpha and O never leave the warp.  P
// keeps f32 precision: it enters as a bf16 high part and a bf16 low part
// (the rest), two products summed in f32.  The warps merge once, after the
// last tile, then the cluster.
template <int HD>
__global__ void __launch_bounds__(kRingThreads) flash_decode_bf16_kernel(DecodeArgs a) {
  constexpr int TK = ring_tile<HD>(), LD = ring_ld<HD>();
  constexpr int WK = TK / kRingWarps;  // keys per warp per tile: 8 or 16
  constexpr int NT = WK / 8;           // score n-tiles per warp
  constexpr int KS = HD / 16;          // k-steps of the score product
  constexpr int NO = HD / 8;           // output n-tiles
  static_assert(NT == 2 || NO % 4 == 0, "8-key warps take V in groups of 4 n-tiles");
  cluster_arrive_relaxed();
  const Work wk = block_work(a, static_cast<int>(cg::this_cluster().block_rank()));
  const int nh = wk.nh;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kStages * TK * LD;
  float* Fw = reinterpret_cast<float*>(smem_raw + ring_bytes<HD>());  // [warps][nh] weights
  float* Mw = Fw + kRingWarps * nh;  // [warps][nh]
  float* Lw = Mw + kRingWarps * nh;  // [warps][nh]
  float* m = Lw + kRingWarps * nh;   // the block's [nh]
  float* l = m + nh;
  float* rx = l + nh;
  float* Ow = reinterpret_cast<float*>(smem_raw);  // [warps][nh][HD], on the ring

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const bf16* kb = static_cast<const bf16*>(a.k) + wk.b * a.ksb + wk.kh * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + wk.b * a.vsb + wk.kh * a.vsh;
  const int n_tiles = wk.k_begin < wk.k_stop ? (wk.k_stop - wk.k_begin + TK - 1) / TK : 0;

  // q as A fragments, loaded first (they do not wait for the row's length):
  // row g (head g of the block; zero past nh), dims 16 ks + 2c + {0, 1} and
  // + 8.
  uint32_t qa[KS][2];
  {
    const bf16* qr = static_cast<const bf16*>(a.q) + wk.b * a.qsb + (wk.h0 + g) * a.qsh;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = g < nh ? *reinterpret_cast<const uint32_t*>(qr + ks * 16 + 2 * c) : 0u;
      qa[ks][1] = g < nh ? *reinterpret_cast<const uint32_t*>(qr + ks * 16 + 8 + 2 * c) : 0u;
    }
  }
  // Then the first kStages - 1 tiles.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_stage<HD>(Ks + s * TK * LD, kb, a.kss, wk.k_begin + s * TK, wk.k_stop);
      load_stage<HD>(Vs + s * TK * LD, vb, a.vss, wk.k_begin + s * TK, wk.k_stop);
    }
    cp_async_commit();
  }

  float o[NO][4];  // O: rows g (and g + 8, zero), dims 8 n + 2c + {0, 1}
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_g = -INFINITY, l_g = 0.f;  // head g: running max; this lane's share of the sum

  for (int it = 0, stage = 0; it < n_tiles; ++it, stage = stage + 1 == kStages ? 0 : stage + 1) {
    cp_async_wait<kStages - 2>();  // tile `it` has landed
    __syncthreads();               // ... for every thread; and tile it - 1 is consumed
    {
      const int nxt = it + kStages - 1;
      const int ns = stage == 0 ? kStages - 1 : stage - 1;
      if (nxt < n_tiles) {
        load_stage<HD>(Ks + ns * TK * LD, kb, a.kss, wk.k_begin + nxt * TK, wk.k_stop);
        load_stage<HD>(Vs + ns * TK * LD, vb, a.vss, wk.k_begin + nxt * TK, wk.k_stop);
      }
      cp_async_commit();
    }
    const int kw0 = wk.k_begin + it * TK + warp * WK;  // the warp's first key
    if (kw0 >= wk.k_stop) continue;                    // all of its keys are past the split
    const bf16* Kt = Ks + (stage * TK + warp * WK) * LD;
    const bf16* Vt = Vs + (stage * TK + warp * WK) * LD;

    // Even and odd k-steps in two sums, so each chain of dependent
    // products is half as long.
    float s[NT][4], s_odd[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s_odd[nt][e] = 0.f;
      const bf16* kr = Kt + (nt * 8 + (lane & 7)) * LD + (lane >> 3) * 8;
#pragma unroll
      for (int ks = 0; ks + 1 < KS; ks += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kr + ks * 16);
        const uint32_t a0[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
        const uint32_t a1[4] = {qa[ks + 1][0], 0u, qa[ks + 1][1], 0u};
        mma_bf16(s[nt], a0, kf[0], kf[1]);
        mma_bf16(s_odd[nt], a1, kf[2], kf[3]);
      }
      if constexpr (KS % 2) {
        uint32_t kf[2];
        ldmatrix_x2(kf, Kt + (nt * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8 + (KS - 1) * 16);
        const uint32_t a0[4] = {qa[KS - 1][0], 0u, qa[KS - 1][1], 0u};
        mma_bf16(s[nt], a0, kf[0], kf[1]);
      }
      s[nt][0] += s_odd[nt][0];
      s[nt][1] += s_odd[nt][1];
    }

    // Online softmax of head g over the warp's keys; masked keys get -inf,
    // and a head that has seen no key yet keeps m = -inf, l = 0.
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = kw0 + nt * 8 + 2 * c + e;
        s[nt][e] = kp < wk.k_stop ? score(s[nt][e], a.scale, a.cap) : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_g, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = __expf(m_g - m_use);
    m_g = m_new;
    uint32_t ph[2] = {0u, 0u}, pl[2] = {0u, 0u};  // P's high and low bf16 parts
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = __expf(s[nt][0] - m_use), p1 = __expf(s[nt][1] - m_use);
      sum += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
      ph[nt] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[nt] = *reinterpret_cast<const uint32_t*>(&lo);
    }
    l_g = l_g * alpha + sum;

    // O = alpha O + P V.
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    const uint32_t ah[4] = {ph[0], 0u, ph[1], 0u}, al[4] = {pl[0], 0u, pl[1], 0u};
    if constexpr (NT == 2) {
      // 16 keys: B fragments of keys 0-7 and 8-15, two n-tiles a load.
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + n * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(o[n], ah, vf[0], vf[1]);
        mma_bf16(o[n], al, vf[0], vf[1]);
        mma_bf16(o[n + 1], ah, vf[2], vf[3]);
        mma_bf16(o[n + 1], al, vf[2], vf[3]);
      }
    } else {
      // 8 keys: keys 8-15 of the k-step are zero in P and not read from V.
#pragma unroll
      for (int n = 0; n < NO; n += 4) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (lane & 7) * LD + (n + (lane >> 3)) * 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          mma_bf16(o[n + q], ah, vf[q], 0u);
          mma_bf16(o[n + q], al, vf[q], 0u);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it now holds the warps' outputs

  // The warps' partial sums: head g's max and sum from its quad, its
  // outputs from the accumulators.
  l_g += __shfl_xor_sync(0xffffffffu, l_g, 1);
  l_g += __shfl_xor_sync(0xffffffffu, l_g, 2);
  if (g < nh) {
    if (c == 0) {
      Mw[warp * nh + g] = m_g;
      Lw[warp * nh + g] = l_g;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(Ow + (warp * nh + g) * HD + n * 8 + 2 * c) =
          make_float2(o[n][0], o[n][1]);
  }
  __syncthreads();
  // Each warp's weight for each head: exp(m_w - max).
  for (int r = threadIdx.x; r < nh; r += kRingThreads) {
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < kRingWarps; ++q) mx = fmaxf(mx, Mw[q * nh + r]);
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kRingWarps; ++q) {
      const float mq = Mw[q * nh + r];
      const float f = mq == -INFINITY ? 0.f : __expf(mq - mx);
      Fw[q * nh + r] = f;
      sum = fmaf(f, Lw[q * nh + r], sum);
    }
    m[r] = mx;
    l[r] = sum;
  }
  __syncthreads();
  cluster_merge<bf16, HD>(
      a, wk, m, l,
      [&](int e) {
        const int r = e / HD;
        float o = 0.f;
#pragma unroll
        for (int q = 0; q < kRingWarps; ++q) o = fmaf(Fw[q * nh + r], Ow[q * nh * HD + e], o);
        return o;
      },
      rx);
}

// The kernel's launch: grid (cluster, K * groups, B), the cluster along x.
template <typename Kernel>
cudaError_t configure(Kernel kernel, int cluster, dim3 grid, int threads, size_t smem,
                      cudaStream_t stream, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, const DecodeArgs& a, int cluster, int K, int B,
                           int threads, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, cluster, dim3(cluster, K * a.groups, B), threads, smem,
                              stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` blocks the card holds at once (negative:
// a cudaError_t).
template <typename Kernel>
int resident_clusters(Kernel kernel, int cluster, int threads, size_t smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, cluster, dim3(cluster, 1, 1), threads, smem, nullptr, cfg,
                              attr);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <int HD>
cudaError_t launch(int dtype, const DecodeArgs& a, int cluster, int K, int B,
                   cudaStream_t stream) {
  if (dtype == kFloat32)
    return launch_cluster(flash_decode_f32_kernel<HD>, a, cluster, K, B, kF32Threads,
                          f32_smem_bytes<HD>(a.heads), stream);
  return launch_cluster(flash_decode_bf16_kernel<HD>, a, cluster, K, B, kRingThreads,
                        bf16_smem_bytes<HD>(a.heads), stream);
}

template <int HD>
int resident(int dtype, int heads, int cluster) {
  if (dtype == kFloat32)
    return resident_clusters(flash_decode_f32_kernel<HD>, cluster, kF32Threads,
                             f32_smem_bytes<HD>(heads));
  return resident_clusters(flash_decode_bf16_kernel<HD>, cluster, kRingThreads,
                           bf16_smem_bytes<HD>(heads));
}

template <int HD>
size_t smem_bytes(int dtype, int heads) {
  return dtype == kFloat32 ? f32_smem_bytes<HD>(heads) : bf16_smem_bytes<HD>(heads);
}

template <int HD>
int tile_keys(int dtype) {
  return dtype == kFloat32 ? kF32Tile : ring_tile<HD>();
}

// The supported head sizes; each call below switches over them.
#define REPRO_DECODE_HEAD_DIMS(X) X(16) X(32) X(64) X(128) X(160) X(256)

}  // namespace
}  // namespace repro

// Dynamic shared memory of a block of the decode kernel for a type code,
// head size and heads per block; 0 for an unsupported head size.
extern "C" int repro_flash_decode_smem(int dtype, int hd, int heads) {
  using namespace repro;
  switch (hd) {
#define X(HD) \
  case HD: return static_cast<int>(smem_bytes<HD>(dtype, heads));
    REPRO_DECODE_HEAD_DIMS(X)
#undef X
    default: return 0;
  }
}

// How many clusters of `cluster` blocks, each serving `heads` query heads,
// the card holds at once for a type code and head size (the plan's
// `resident`); negative: a cudaError_t.
extern "C" int repro_flash_decode_clusters(int dtype, int hd, int heads, int cluster) {
  using namespace repro;
  if (cluster <= 0 || cluster > kMaxCluster || heads <= 0) return -cudaErrorInvalidValue;
  switch (hd) {
#define X(HD) \
  case HD: return resident<HD>(dtype, heads, cluster);
    REPRO_DECODE_HEAD_DIMS(X)
#undef X
    default: return -cudaErrorInvalidValue;
  }
}

// q (B, H, hd), k and v caches (B, S, K, hd), lengths (B,) int32 on the
// device, o (B, H, hd), each with a unit stride in its last dimension;
// strides are in elements, and rows must be 16-byte aligned.  The plan
// (kernels/decode_attention.py, ``plan``): `cluster` blocks split each
// row's keys into splits of `chunk` keys, and each of them serves `heads`
// query heads of its KV head; `tile` must be the kernel's keys per stage.
// window <= 0 and cap <= 0 disable the window and the softcap.  A sequence
// shard: the cache holds keys [offset + offsets[b], ... + S) of row b
// (offsets may be null), lengths and window in global positions; lse, where
// not null, takes each (row, head)'s f32 log-sum-exp at lse[b * lsb + h *
// lsh].  Returns a cudaError_t.
extern "C" int repro_flash_decode_shard(int dtype, int hd, const void* q, const void* k,
                                        const void* v, const int* lengths, void* o,
                                        const int* offsets, int offset, float* lse, int B,
                                        int H, int K, int S, int cluster, int chunk, int tile,
                                        int heads, long long qsb, long long qsh, long long ksb,
                                        long long kss, long long ksh, long long vsb,
                                        long long vss, long long vsh, long long osb,
                                        long long osh, long long lsb, long long lsh,
                                        float scale, int window, float cap, void* stream) {
  using namespace repro;
  if (B <= 0) return cudaSuccess;
  if (K <= 0 || H % K != 0 || heads <= 0 || heads > H / K || cluster <= 0 ||
      cluster > kMaxCluster || chunk <= 0 || (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  const int R = H / K;
  const DecodeArgs a{q,   k,   v,   lengths, o,   R,     heads, (R + heads - 1) / heads,
                     S,   chunk, qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh,
                     scale, cap, window, offsets, offset, lse, lsb, lsh};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define X(HD)                                                     \
  case HD:                                                        \
    if (tile != tile_keys<HD>(dtype) || heads > kMaxHeads) \
      return cudaErrorInvalidValue;                               \
    return launch<HD>(dtype, a, cluster, K, B, st);
    REPRO_DECODE_HEAD_DIMS(X)
#undef X
    default: return cudaErrorInvalidValue;
  }
}
