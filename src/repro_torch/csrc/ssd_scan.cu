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
// product), so the card's memory bounds it (~0.05 ms at 3.35 TB/s).
//
// What the design does about it, and what it leaves for later:
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
//   * bf16 runs C B^T on the tensor cores (mma.sync m16n8k16, f32
//     accumulate, exact products as in the reference); the masked, decayed
//     scores stay in f32 and their product with X, and the state product,
//     run on the CUDA cores in f32, so nothing the reference keeps in f32
//     is rounded to bf16.  f32 runs everything on the CUDA cores;
//   * outputs are f32, contiguous: y_diag (B, S, nh, hd) in the model's
//     layout, states (B, nC, nh, hd, N) in the layout of the recurrent
//     state, cum (B, S, nh) in a's layout.
// Left for later: wgmma and TMA, and sharing C B^T between the heads of a
// batch row (it is recomputed per head here).

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;  // four warps; each owns 16 rows of a strip
constexpr int kR = 64;         // rows of a strip, query and key alike
constexpr int kLdp = kR + 8;   // padded row of the score tile (conflict-free float2 stores)
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

// Row of a (kR, N) strip of B or C in shared memory: bf16 rows padded so
// the 8 rows of an ldmatrix hit distinct banks, f32 rows so 32 lanes
// reading 32 rows hit 32 banks.
template <typename T, int N>
__host__ __device__ constexpr int strip_ld() {
  return std::is_same<T, float>::value ? N + 1 : N + 8;
}

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

// The 16 / sizeof(T) elements of a 16-byte piece, widened to f32.
template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* out) {
  Vec16<T>::load(reinterpret_cast<const T*>(&v), out);
}

template <typename T, int HD, int N>
constexpr size_t smem_bytes() {
  // X strip f32, score tile f32, cum, then the C and B strips in T (reused
  // as one f32 (kR, N) strip of decayed B by the state pass).
  return sizeof(float) * (kR * HD + kR * kLdp + kMaxQ) + 2 * sizeof(T) * kR * strip_ld<T, N>();
}

template <typename T, int HD, int N>
__global__ void __launch_bounds__(kThreads) ssd_intra_chunk_kernel(SsdArgs a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LDN = strip_ld<T, N>();
  constexpr int NC = (HD + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);
  float* Ps = Xs + kR * HD;
  float* cum = Ps + kR * kLdp;
  T* Cs = reinterpret_cast<T*>(cum + kMaxQ);
  T* Bs = Cs + kR * LDN;
  float* Bd = reinterpret_cast<float*>(Cs);  // the state pass's (kR, N) strip

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int Q = a.Q, s0 = chunk * Q;
  const T* xb = static_cast<const T*>(a.x) + bi * a.xsb + h * a.xsh + s0 * a.xss;
  const T* bb = static_cast<const T*>(a.b) + bi * a.bsb + s0 * a.bss;
  const T* cb = static_cast<const T*>(a.c) + bi * a.csb + s0 * a.css;
  const float* ab = a.a + bi * a.asb + h * a.ash + s0 * a.ass;
  const long long row0 = static_cast<long long>(bi) * a.S + s0;  // first output row

  // --- cum: warp 0 scans the chunk's log decays, up to 8 per lane -------
  if (warp == 0) {
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

  constexpr int V = 16 / sizeof(T);
  auto load_x = [&](int j0) {  // the X strip, widened to f32
    load_strip<T, HD>(xb, a.xss, j0, Q, [&](int r, int c, const uint4& v) {
      float f[V];
      widen<T>(v, f);
#pragma unroll
      for (int q = 0; q < V; q += 4)
        *reinterpret_cast<float4*>(Xs + r * HD + c + q) = make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
    });
  };
  // A strip of B or C as it is (bf16: 16-byte stores into the padded rows)
  // or, in f32, element by element into the odd-strided rows.
  auto load_bc = [&](T* dst, const T* src, long long ld, int r0) {
    load_strip<T, N>(src, ld, r0, Q, [&](int r, int c, const uint4& v) {
      if constexpr (kBf16) {
        *reinterpret_cast<uint4*>(dst + r * LDN + c) = v;
      } else {
        const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[r * LDN + c + q] = f[q];
      }
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
      if constexpr (kBf16) {
        float s[kR / 8][4];
#pragma unroll
        for (int n = 0; n < kR / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < N; kk += 16) {
          uint32_t ca[4];
          ldmatrix_x4(ca, Cs + (wr0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN + kk +
                              (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < kR / 8; n += 2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, Bs + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LDN + kk +
                                ((lane >> 3) & 1) * 8);
            mma_bf16(s[n], ca, bf[0], bf[1]);
            mma_bf16(s[n + 1], ca, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kR / 8; ++n) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wr0 + g + 8 * half, i = i0 + r;
            float out[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + n * 8 + 2 * t + e;
              out[e] = (i < Q && i >= j) ? s[n][2 * half + e] * expf(cum[i] - cum[j]) : 0.f;
            }
            *reinterpret_cast<float2*>(Ps + r * kLdp + n * 8 + 2 * t) = make_float2(out[0], out[1]);
          }
        }
      } else {
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
    load_strip<T, N>(bb, a.bss, j0, Q, [&](int r, int c, const uint4& v) {
      float f[V];
      widen<T>(v, f);
      const float d = j0 + r < Q ? decay[j0 + r] : 0.f;
#pragma unroll
      for (int q = 0; q < V; q += 4)
        *reinterpret_cast<float4*>(Bd + r * N + c + q) =
            make_float4(f[q] * d, f[q + 1] * d, f[q + 2] * d, f[q + 3] * d);
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

template <typename T, int HD, int N>
cudaError_t launch(const SsdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD, N>();
  cudaError_t err = allow_smem(ssd_intra_chunk_kernel<T, HD, N>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / a.Q, a.nh, B);
  ssd_intra_chunk_kernel<T, HD, N><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sizes(int hd, int n, const SsdArgs& a, int B, cudaStream_t stream) {
  switch (hd * 1000 + n) {
    case 16016: return launch<T, 16, 16>(a, B, stream);
    case 16064: return launch<T, 16, 64>(a, B, stream);
    case 16128: return launch<T, 16, 128>(a, B, stream);
    case 64016: return launch<T, 64, 16>(a, B, stream);
    case 64064: return launch<T, 64, 64>(a, B, stream);
    case 64128: return launch<T, 64, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

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
  const SsdArgs args{x, a, b, c, y, st, cum, S, nh, Q, xsb, xss, xsh,
                     asb, ass, ash, bsb, bss, csb, css};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_sizes<__nv_bfloat16>(hd, n_state, args, B, s);
  if (dtype == kFloat32) return launch_sizes<float>(hd, n_state, args, B, s);
  return cudaErrorInvalidValue;
}
