// ssd_intra_chunk: the intra-chunk block of Mamba-2's chunked SSD, for prefill.
//
// Replaces the Pallas TPU kernel ssd_intra_chunk
// (src/repro/kernels/ssd_scan.py, body _ssd_chunk_kernel).  For each
// (chunk, head, batch) it computes, over the chunk's Q steps:
//
//   cum     = cumsum(a)                                     (Q,)
//   L[i,j]  = exp(cum[i] - cum[j]) for i >= j, else 0       (Q, Q)
//   y_diag  = (C B^T * L) X                                 (Q, hd)
//   state   = (B * exp(cum[Q-1] - cum))^T X                 (N, hd), written (hd, N)
//
// all in f32, as the reference does.
//
// What bounds it on an H100: at mamba2-2.7b's prefill (B=4, S=1024, 80
// heads of 64, N=128, Q=256, bf16 in, f32 out) one launch moves ~173 MB
// (the f32 outputs are most of it) and ~21.5 GFLOP in its causal products
// (the lower triangle of C B^T and of its product with X, and the state
// product), so the card's memory bounds it (~0.05 ms at 3.35 TB/s).  On
// the CUDA cores in f32 those products alone would take ~0.18 ms at their
// peak rate, so the bf16 kernel runs all three on the tensor cores; it
// then takes ~0.245 ms, held back by the latency of each block's chain of
// strip loads, barriers and dependent products with four blocks an SM.
//
// What the design does about it:
//   * one block per (chunk, head, batch); the Q x Q scores (256 KB in f32)
//     never exist whole: the block walks strips of 64 query rows and, for
//     each, the key strips at or left of the diagonal, so tiles above the
//     diagonal (wholly zero in L) are never computed;
//   * B and C are shared by every head of a batch row: they are read in
//     place from the (B, S, N) column slices of the model's xBC tensor
//     through strides, as are x (B, S, nh, hd) and a (B, S, nh); the JAX
//     glue copies B and C out to every head first;
//   * strips are read 16 bytes a load, every load of a strip in flight
//     before the first store (the rows of x, B and C are 16-byte aligned);
//   * the mask is applied before exp, so exp never sees i < j (no inf * 0);
//   * bf16 (ssd_intra_chunk_bf16_kernel) runs every product on the tensor
//     cores (mma.sync m16n8k16, f32 accumulate).  C B^T is exact, as in the
//     reference.  Each warp keeps its 16 rows of masked, decayed f32 scores
//     in the accumulator registers, which are already the A fragments of
//     the product with X; each score is split into a bf16 high part and the
//     bf16 rounding of the rest, and y += hi X + lo X, with X's fragments
//     read from a bf16 strip by ldmatrix.trans.  The state product runs as
//     state^T = (X * decay)^T B, the f32 X * decay split the same way and
//     staged in the shared memory the C strip frees.  The two parts carry
//     ~16 bits of each f32 operand, where one bf16 rounding (8 bits) would
//     fail the 1e-3 tolerance ~20x over at mamba2's chunk.  The mask and
//     decay take no branch (a masked score's exponent is -inf), and the
//     kernel is held to 128 registers, four blocks an SM (the state's
//     accumulators at N 128 are taken in two passes over the keys for it);
//   * f32 (ssd_intra_chunk_f32_kernel) runs everything on the CUDA cores;
//   * outputs are f32, contiguous: y_diag (B, S, nh, hd) in the model's
//     layout, states (B, nC, nh, hd, N) in the layout of the recurrent
//     state, cum (B, S, nh) in a's layout.
// Tried and slower on the card: the key strips through a 2-stage cp.async
// ring (its registers and shared memory cost blocks an SM, and at equal
// blocks it did not gain), cp.async in place of the register-staged loads,
// exp2-based __expf, and five blocks an SM at N 64.
// Left for later: sharing C B^T between the heads of a batch row (it is
// recomputed per head here), fewer reloads of the key strips (each query
// strip and the state pass reload them), wgmma and TMA.

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps; each owns 16 rows of a strip
constexpr int kR = 64;         // rows of a strip, query and key alike
constexpr int kLdp = kR + 8;   // padded row of the f32 kernel's score tile (conflict-free float2 stores)
constexpr int kMaxQ = 256;

struct SsdArgs {
  const void* x;
  const float* a;
  const void* b;
  const void* c;
  float* y;
  float* st;
  float* cum;
  int S, nh, Q;
  long long xsb, xss, xsh, asb, ass, ash, bsb, bss, csb, css;
};

// Reads rows [r0, r0 + kR) of a row-major (rows, W) matrix in T (row
// stride ld elements, 16-byte aligned rows) 16 bytes at a time, all loads
// issued before any store, and hands each piece to store(r, c, v): row r
// of the strip, first column c, the piece v.  Rows at or past Q read as 0.
template <typename T, int W, typename Store>
__device__ __forceinline__ void load_strip(const T* src, long long ld, int r0, int Q,
                                           Store store) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int kVecs = kR * W / V;
  constexpr int kIters = (kVecs + kThreads - 1) / kThreads;
  uint4 buf[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int e = threadIdx.x + k * kThreads, r = e / (W / V), c = (e - r * (W / V)) * V;
    buf[k] = make_uint4(0u, 0u, 0u, 0u);
    if (e < kVecs && r0 + r < Q)
      buf[k] = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int e = threadIdx.x + k * kThreads, r = e / (W / V), c = (e - r * (W / V)) * V;
    if (e < kVecs) store(r, c, buf[k]);
  }
}

// The cumulative log decays of the block's chunk: warp 0 scans up to 8 a
// lane into cum (shared memory); then every thread writes them out.
__device__ __forceinline__ void chunk_cumsum(const SsdArgs& a, const float* ab, long long row0,
                                             int h, float* cum) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int Q = a.Q;
  if (tid < 32) {
    const int per = (Q + 31) / 32;
    float v[kMaxQ / 32], run = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxQ / 32; ++k) {
      const int i = lane * per + k;
      if (k < per && i < Q) run += ab[i * a.ass];
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const float off = incl - run;
#pragma unroll
    for (int k = 0; k < kMaxQ / 32; ++k) {
      const int i = lane * per + k;
      if (k < per && i < Q) cum[i] = v[k] + off;
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads) a.cum[(row0 + i) * a.nh + h] = cum[i];
}

// ---------------------------------------------------------------------------
// f32: every product on the CUDA cores.
// ---------------------------------------------------------------------------
template <int HD, int N>
constexpr size_t f32_smem_bytes() {
  // X strip, score tile, cum, then the C and B strips in odd-strided rows
  // (32 lanes reading 32 rows hit 32 banks; reused as one (kR, N) strip of
  // decayed B by the state pass).
  return sizeof(float) * (kR * HD + kR * kLdp + kMaxQ + 2 * kR * (N + 1));
}

template <int HD, int N>
__global__ void __launch_bounds__(kThreads) ssd_intra_chunk_f32_kernel(SsdArgs a) {
  constexpr int LDN = N + 1;
  constexpr int NC = (HD + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);
  float* Ps = Xs + kR * HD;
  float* cum = Ps + kR * kLdp;
  float* Cs = cum + kMaxQ;
  float* Bs = Cs + kR * LDN;
  float* Bd = Cs;  // the state pass's (kR, N) strip

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int Q = a.Q, s0 = chunk * Q;
  const float* xb = static_cast<const float*>(a.x) + bi * a.xsb + h * a.xsh + s0 * a.xss;
  const float* bb = static_cast<const float*>(a.b) + bi * a.bsb + s0 * a.bss;
  const float* cb = static_cast<const float*>(a.c) + bi * a.csb + s0 * a.css;
  const float* ab = a.a + bi * a.asb + h * a.ash + s0 * a.ass;
  const long long row0 = static_cast<long long>(bi) * a.S + s0;  // first output row

  chunk_cumsum(a, ab, row0, h, cum);

  auto load_x = [&](int j0) {
    load_strip<float, HD>(xb, a.xss, j0, Q, [&](int r, int c, const uint4& v) {
      *reinterpret_cast<uint4*>(Xs + r * HD + c) = v;
    });
  };
  auto load_bc = [&](float* dst, const float* src, long long ld, int r0) {
    load_strip<float, N>(src, ld, r0, Q, [&](int r, int c, const uint4& v) {
      const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[r * LDN + c + q] = f[q];
    });
  };

  // --- y_diag: strips of 64 query rows, key strips at or left of the diagonal
  for (int i0 = 0; i0 < Q; i0 += kR) {
    __syncthreads();  // every warp is done with the previous C strip
    load_bc(Cs, cb, a.css, i0);
    const int wr0 = warp * 16;  // this warp's first row in the strip
    float acc[16][NC];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

    for (int j0 = 0; j0 <= i0; j0 += kR) {
      __syncthreads();  // every warp is done with the previous B and X strips
      load_bc(Bs, bb, a.bss, j0);
      load_x(j0);
      __syncthreads();

      // Scores C B^T for this warp's 16 rows and the strip's 64 keys, masked
      // and decayed, into the warp's rows of Ps.
      float s[16][2];
#pragma unroll
      for (int r = 0; r < 16; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float b0 = Bs[lane * LDN + n], b1 = Bs[(lane + 32) * LDN + n];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float cv = Cs[(wr0 + r) * LDN + n];
          s[r][0] = fmaf(cv, b0, s[r][0]);
          s[r][1] = fmaf(cv, b1, s[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int i = i0 + wr0 + r;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + lane + 32 * e;
          Ps[(wr0 + r) * kLdp + lane + 32 * e] =
              (i < Q && i >= j) ? s[r][e] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
      __syncwarp();  // a warp writes and reads only its own rows of Ps

      // acc += P X over the keys; on the diagonal strip this warp's rows see
      // only the keys before their end.
      const int s_end = j0 == i0 ? wr0 + 16 : kR;
      for (int s4 = 0; s4 < s_end; s4 += 4) {
        float xv[4][NC];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int d = lane + 32 * c;
            xv[q][c] = d < HD ? Xs[(s4 + q) * HD + d] : 0.f;
          }
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(Ps + (wr0 + r) * kLdp + s4);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[r][c] = fmaf(p.x, xv[0][c],
                             fmaf(p.y, xv[1][c], fmaf(p.z, xv[2][c], fmaf(p.w, xv[3][c], acc[r][c]))));
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = i0 + wr0 + r;
      if (i >= Q) continue;
      float* yr = a.y + ((row0 + i) * a.nh + h) * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) yr[d] = acc[r][c];
      }
    }
  }

  // --- state: sum over the chunk of (B_j * exp(cum[Q-1] - cum[j])) x_j^T,
  // each thread an 8 x 8 block of the (hd, N) state.
  constexpr int kTasks = (HD / 8) * (N / 8);
  static_assert(kTasks <= kThreads, "one 8x8 state block per thread");
  const int ng = tid % (N / 8), pg = tid / (N / 8);
  float st[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int n = 0; n < 8; ++n) st[p][n] = 0.f;
  const float cum_end = cum[Q - 1];
  __syncthreads();  // cum_end is read, and the y pass is done with cum and the strips
  float* decay = cum;  // cum[i] becomes exp(cum[Q-1] - cum[i]), the decay to the chunk's end
  for (int i = tid; i < Q; i += kThreads) decay[i] = expf(cum_end - cum[i]);
  for (int j0 = 0; j0 < Q; j0 += kR) {
    __syncthreads();  // the decays are written; the strips of the previous pass are consumed
    load_strip<float, N>(bb, a.bss, j0, Q, [&](int r, int c, const uint4& v) {
      const float* f = reinterpret_cast<const float*>(&v);
      const float d = j0 + r < Q ? decay[j0 + r] : 0.f;
      *reinterpret_cast<float4*>(Bd + r * N + c) =
          make_float4(f[0] * d, f[1] * d, f[2] * d, f[3] * d);
    });
    load_x(j0);
    __syncthreads();
    if (tid < kTasks) {
      const int rows = min(kR, Q - j0);
      for (int r = 0; r < rows; ++r) {
        const float4 x0 = *reinterpret_cast<const float4*>(Xs + r * HD + pg * 8);
        const float4 x1 = *reinterpret_cast<const float4*>(Xs + r * HD + pg * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Bd + r * N + ng * 8);
        const float4 b1 = *reinterpret_cast<const float4*>(Bd + r * N + ng * 8 + 4);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int n = 0; n < 8; ++n) st[p][n] = fmaf(xv[p], bv[n], st[p][n]);
      }
    }
  }
  if (tid < kTasks) {
    float* sb = a.st + ((static_cast<long long>(bi) * (a.S / Q) + chunk) * a.nh + h) * HD * N;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float* row = sb + (pg * 8 + p) * N + ng * 8;
      *reinterpret_cast<float4*>(row) = make_float4(st[p][0], st[p][1], st[p][2], st[p][3]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(st[p][4], st[p][5], st[p][6], st[p][7]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: every product on the tensor cores, the f32 operands as bf16 hi + lo.
// ---------------------------------------------------------------------------

// bf16 rows padded by 8 elements, so the 8 rows of an ldmatrix hit 8
// distinct 16-byte bank groups.
template <int W>
__host__ __device__ constexpr int bf16_ld() {
  return W + 8;
}

template <int HD, int N>
__host__ __device__ constexpr int c_region() {  // the C strip, or X * decay's low part
  return kR * (bf16_ld<N>() > bf16_ld<HD>() ? bf16_ld<N>() : bf16_ld<HD>());
}

template <int HD, int N>
constexpr size_t bf16_smem_bytes() {
  // cum, then the C strip (the state pass's low part of X * decay), the B
  // strip, and the X strip (the state pass's high part of X * decay).
  return sizeof(float) * kMaxQ +
         sizeof(bf16) * (c_region<HD, N>() + kR * bf16_ld<N>() + kR * bf16_ld<HD>());
}

// The f32 pair (x0, x1) as its bf16 rounding (hi) and the bf16 rounding of
// what that leaves (lo), each packed as the two halves of a fragment
// register, x0 in the low half.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// At most 128 registers a thread: four blocks an SM.  Five (at most 102
// registers) ran slower at N 64.
template <int HD, int N>
__global__ void __launch_bounds__(kThreads, 4) ssd_intra_chunk_bf16_kernel(SsdArgs a) {
  constexpr int LDN = bf16_ld<N>(), LDX = bf16_ld<HD>();
  constexpr int NO = HD / 8;       // n-tiles of a warp's 16 rows of y
  constexpr int KS = kR / 16;      // k-steps of a key strip
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);
  bf16* Cs = reinterpret_cast<bf16*>(cum + kMaxQ);
  bf16* Bs = Cs + c_region<HD, N>();
  bf16* Xs = Bs + kR * LDN;
  bf16* Xh = Xs;  // the state pass's X * decay, high part
  bf16* Xl = Cs;  // ... and low part

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int Q = a.Q, s0 = chunk * Q;
  const bf16* xb = static_cast<const bf16*>(a.x) + bi * a.xsb + h * a.xsh + s0 * a.xss;
  const bf16* bb = static_cast<const bf16*>(a.b) + bi * a.bsb + s0 * a.bss;
  const bf16* cb = static_cast<const bf16*>(a.c) + bi * a.csb + s0 * a.css;
  const float* ab = a.a + bi * a.asb + h * a.ash + s0 * a.ass;
  const long long row0 = static_cast<long long>(bi) * a.S + s0;  // first output row

  chunk_cumsum(a, ab, row0, h, cum);

  auto store_to = [](bf16* dst, int ld) {
    return [=](int r, int c, const uint4& v) { *reinterpret_cast<uint4*>(dst + r * ld + c) = v; };
  };

  // --- y_diag: strips of 64 query rows, key strips at or left of the diagonal
  for (int i0 = 0; i0 < Q; i0 += kR) {
    __syncthreads();  // every warp is done with the previous C strip
    load_strip<bf16, N>(cb, a.css, i0, Q, store_to(Cs, LDN));
    const int wr0 = warp * 16;  // this warp's first row in the strip
    const int r_lo = i0 + wr0 + g;  // the chunk rows of this thread's accumulators: r_lo, r_lo + 8
    float o[NO][4] = {};

    for (int j0 = 0; j0 <= i0; j0 += kR) {
      __syncthreads();  // every warp is done with the previous B and X strips
      load_strip<bf16, N>(bb, a.bss, j0, Q, store_to(Bs, LDN));
      load_strip<bf16, HD>(xb, a.xss, j0, Q, store_to(Xs, LDX));
      __syncthreads();
      if (i0 + wr0 >= Q) continue;  // every row of this warp is past the chunk
      // k-steps of 16 keys that hold a key at or before the warp's last row
      const int kend = j0 == i0 ? warp + 1 : KS;

      // Scores C B^T for the warp's 16 rows and the strip's 64 keys.
      float s[kR / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < N; kk += 16) {
        uint32_t ca[4];
        ldmatrix_x4(ca, Cs + (wr0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN + kk +
                            (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < kR / 8; n += 2) {
          if (n / 2 >= kend) break;
          uint32_t bf[4];
          ldmatrix_x4(bf, Bs + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LDN + kk +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[n], ca, bf[0], bf[1]);
          mma_bf16(s[n + 1], ca, bf[2], bf[3]);
        }
      }

      // Masked and decayed, in place, without a branch: a masked score's
      // exponent is -inf before exp (exp gives 0; no inf * 0), and rows past
      // the chunk are masked whole, so they stay 0.
      const float ci[2] = {r_lo < Q ? cum[r_lo] : 0.f, r_lo + 8 < Q ? cum[r_lo + 8] : 0.f};
#pragma unroll
      for (int n = 0; n < kR / 8; ++n) {
        if (n / 2 >= kend) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r_lo + 8 * (e >> 1), j = j0 + n * 8 + 2 * t + (e & 1);
          s[n][e] *= expf(i < Q && i >= j ? ci[e >> 1] - cum[j] : -INFINITY);
        }
      }

      // o += P X: k-step kk's A fragment is score n-tiles 2kk and 2kk + 1,
      // as hi and lo; X's B fragments two n-tiles a load.
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk >= kend) break;
        uint32_t ah[4], al[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t xf[4];
          ldmatrix_x4_trans(xf, Xs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                                    n * 8 + (lane >> 4) * 8);
          mma_bf16(o[n], ah, xf[0], xf[1]);
          mma_bf16(o[n], al, xf[0], xf[1]);
          mma_bf16(o[n + 1], ah, xf[2], xf[3]);
          mma_bf16(o[n + 1], al, xf[2], xf[3]);
        }
      }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r_lo + 8 * half;
      if (i >= Q) continue;
      float* yr = a.y + ((row0 + i) * a.nh + h) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(yr + n * 8) = make_float2(o[n][2 * half], o[n][2 * half + 1]);
    }
  }

  // --- state^T (hd, N) = (X * decay)^T B over the chunk's keys, decay =
  // exp(cum[Q-1] - cum).  A warp owns 16 rows of hd and pairs of 8-column
  // n-tiles: all N / 16 pairs at hd 64, a quarter of them at hd 16.  More
  // than 4 pairs (hd 64, N 128) are taken in two passes over the keys, 4 at
  // a time, so that the accumulators fit the 128 registers of four blocks
  // an SM.
  constexpr int MT = HD / 16, WN = 4 / MT, NP = N / 16, PW = (NP + WN - 1) / WN;
  static_assert(MT * WN == 4, "four warps over the state's row tiles");
  constexpr int PASSES = PW > 4 ? 2 : 1, PP = PW / PASSES;  // passes, pairs a pass
  const int m0 = (warp % MT) * 16;
  const float cum_end = cum[Q - 1];
  __syncthreads();  // cum_end is read, and the y pass is done with cum and the strips
  float* decay = cum;  // cum[i] becomes exp(cum[Q-1] - cum[i]), the decay to the chunk's end
  for (int i = tid; i < Q; i += kThreads) decay[i] = expf(cum_end - cum[i]);
  float* sb = a.st + ((static_cast<long long>(bi) * (a.S / Q) + chunk) * a.nh + h) * HD * N;
  for (int pass = 0; pass < PASSES; ++pass) {
    const int p0 = (warp / MT) * PW + pass * PP;
    float st[2 * PP][4] = {};
    for (int j0 = 0; j0 < Q; j0 += kR) {
      __syncthreads();  // the decays are written; the strips of the previous pass are consumed
      load_strip<bf16, N>(bb, a.bss, j0, Q, store_to(Bs, LDN));
      load_strip<bf16, HD>(xb, a.xss, j0, Q, [&](int r, int c, const uint4& v) {
        float f[8];
        Vec16<bf16>::load(reinterpret_cast<const bf16*>(&v), f);
        const float d = j0 + r < Q ? decay[j0 + r] : 0.f;
        uint4 hi, lo;
        split_bf16(f[0] * d, f[1] * d, hi.x, lo.x);
        split_bf16(f[2] * d, f[3] * d, hi.y, lo.y);
        split_bf16(f[4] * d, f[5] * d, hi.z, lo.z);
        split_bf16(f[6] * d, f[7] * d, hi.w, lo.w);
        *reinterpret_cast<uint4*>(Xh + r * LDX + c) = hi;
        *reinterpret_cast<uint4*>(Xl + r * LDX + c) = lo;
      });
      __syncthreads();
      const int ksteps = (min(kR, Q - j0) + 15) / 16;  // rows past Q are zero
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk >= ksteps) break;
        // A = (X * decay)^T: rows of hd, columns of keys, read transposed
        // from the (key, hd) strips.
        const int arow = kk * 16 + (lane & 7) + (lane >> 4) * 8, acol = m0 + ((lane >> 3) & 1) * 8;
        uint32_t ah[4], al[4];
        ldmatrix_x4_trans(ah, Xh + arow * LDX + acol);
        ldmatrix_x4_trans(al, Xl + arow * LDX + acol);
#pragma unroll
        for (int pp = 0; pp < PP; ++pp) {
          const int p = p0 + pp;
          if (p >= NP) break;
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, Bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                                    p * 16 + (lane >> 4) * 8);
          mma_bf16(st[2 * pp], ah, bf[0], bf[1]);
          mma_bf16(st[2 * pp], al, bf[0], bf[1]);
          mma_bf16(st[2 * pp + 1], ah, bf[2], bf[3]);
          mma_bf16(st[2 * pp + 1], al, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int pp = 0; pp < PP; ++pp) {
      const int p = p0 + pp;
      if (p >= NP) break;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(sb + (m0 + g + 8 * half) * N + p * 16 + q * 8 + 2 * t) =
              make_float2(st[2 * pp + q][2 * half], st[2 * pp + q][2 * half + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t start(Kernel kernel, size_t smem, const SsdArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.S / a.Q, a.nh, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD, int N>
cudaError_t launch(int dtype, const SsdArgs& a, int B, cudaStream_t stream) {
  if (dtype == kBFloat16)
    return start(ssd_intra_chunk_bf16_kernel<HD, N>, bf16_smem_bytes<HD, N>(), a, B, stream);
  return start(ssd_intra_chunk_f32_kernel<HD, N>, f32_smem_bytes<HD, N>(), a, B, stream);
}

template <int HD, int N>
size_t smem_bytes(int dtype) {
  return dtype == kBFloat16 ? bf16_smem_bytes<HD, N>() : f32_smem_bytes<HD, N>();
}

}  // namespace
}  // namespace repro

// Dynamic shared memory of the kernel for a type code and (hd, N); -1 if
// the sizes are not built.
extern "C" int repro_ssd_intra_chunk_smem(int dtype, int hd, int n_state) {
  using namespace repro;
  if (dtype != kBFloat16 && dtype != kFloat32) return -1;
  switch (hd * 1000 + n_state) {
    case 16016: return static_cast<int>(smem_bytes<16, 16>(dtype));
    case 16064: return static_cast<int>(smem_bytes<16, 64>(dtype));
    case 16128: return static_cast<int>(smem_bytes<16, 128>(dtype));
    case 64016: return static_cast<int>(smem_bytes<64, 16>(dtype));
    case 64064: return static_cast<int>(smem_bytes<64, 64>(dtype));
    case 64128: return static_cast<int>(smem_bytes<64, 128>(dtype));
    default: return -1;
  }
}

// x (B, S, nh, hd) and b, c (B, S, N) in the input type, a (B, S, nh) f32,
// each with a unit stride in its last dimension (a's strides are all
// passed); strides are in elements.  Outputs are contiguous f32: y
// (B, S, nh, hd), st (B, S / Q, nh, hd, N), cum (B, S, nh).  Q divides S and
// is at most 256.  Returns a cudaError_t.
extern "C" int repro_ssd_intra_chunk(int dtype, int hd, int n_state, const void* x,
                                     const float* a, const void* b, const void* c, float* y,
                                     float* st, float* cum, int B, int S, int nh, int Q,
                                     long long xsb, long long xss, long long xsh,
                                     long long asb, long long ass, long long ash,
                                     long long bsb, long long bss, long long csb,
                                     long long css, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (Q <= 0 || Q > kMaxQ || S % Q != 0) return cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return cudaErrorInvalidValue;
  const SsdArgs args{x, a, b, c, y, st, cum, S, nh, Q, xsb, xss, xsh,
                     asb, ass, ash, bsb, bss, csb, css};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd * 1000 + n_state) {
    case 16016: return launch<16, 16>(dtype, args, B, s);
    case 16064: return launch<16, 64>(dtype, args, B, s);
    case 16128: return launch<16, 128>(dtype, args, B, s);
    case 64016: return launch<64, 16>(dtype, args, B, s);
    case 64064: return launch<64, 64>(dtype, args, B, s);
    case 64128: return launch<64, 128>(dtype, args, B, s);
    default: return cudaErrorInvalidValue;
  }
}
