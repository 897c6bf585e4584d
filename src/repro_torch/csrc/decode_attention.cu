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
// that is ~11.2 MB a layer, ~3.3 us at 3.35 TB/s; the arithmetic is ~4 flop
// per byte, far below the card's balance point.  So the kernel has to keep
// enough loads in flight on enough SMs.
//
// What the design does about it:
//   * one block per (split of the sequence, KV head, batch) serves all
//     q_per_kv query heads of that KV head from a single read of each K/V
//     tile, so the cache is read once; the splits (flash-decoding) give
//     B*K = 32 (batch, KV head) pairs enough blocks to fill the 132 SMs, and
//     a second small kernel merges the splits' partial softmax sums;
//   * the cache is read in place in the model's (B, S, K, hd) layout through
//     strides with 16-byte loads (the JAX wrapper transposes the whole cache
//     on every call);
//   * lengths are read from device memory, so the host never waits; the keys
//     read are [len - window, len) on local layers and [0, len) otherwise,
//     so entries outside that range are never read, and any cache length S
//     works.
// Rows with len == 0 are outside the contract (the reference returns the
// mean of V there, this kernel returns 0).

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;  // keys per tile

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* part;  // (B, H, nsplit, HD + 2): a split's unnormalized output, max, sum
  int q_per_kv, S, nsplit, chunk;
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh;
  float scale, cap;
  int window;
};

template <int HD>
size_t decode_smem_bytes(int R) {
  // q [R][HD], K [kBK][HD + 1], V [kBK][HD], P [R][kBK], acc [R][HD],
  // m, l, alpha [R], all f32.
  return sizeof(float) * (R * HD + kBK * (HD + 1) + kBK * HD + R * kBK + R * HD + 3 * R);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(DecodeArgs a) {
  constexpr int KS = HD + 1;  // padded K row: consecutive keys fall in distinct banks
  constexpr int N = Vec16<T>::N;
  constexpr int kChunks = HD / N;
  const int R = a.q_per_kv;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + R * HD;
  float* Vs = Ks + kBK * KS;
  float* Ps = Vs + kBK * HD;
  float* acc = Ps + R * kBK;
  float* m = acc + R * HD;
  float* l = m + R;
  float* alpha = l + R;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + kh * R * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsh;

  const int len = min(a.lengths[b], a.S);
  const int k_first = a.window > 0 ? max(0, len - a.window) : 0;
  const int k_begin = k_first + split * a.chunk;
  const int k_stop = min(len, k_begin + a.chunk);

  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    Qs[i] = to_f32(qb[r * a.qsh + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_stop; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q, m, l stored)
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int j = i / kChunks, d = (i - j * kChunks) * N, kp = k0 + j;
      float kv[N], vv[N];
      if (kp < k_stop) {
        Vec16<T>::load(kb + kp * a.kss + d, kv);
        Vec16<T>::load(vb + kp * a.vss + d, vv);
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
    for (int i = tid; i < R * kBK; i += kThreads) {
      const int r = i / kBK, j = i - r * kBK;
      const float* qr = Qs + r * HD;
      const float* kr = Ks + j * KS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      Ps[i] = k0 + j < k_stop ? score(dot, a.scale, a.cap) : kMask;
    }
    __syncthreads();

    // Online softmax: one warp per head.
    for (int r = warp; r < R; r += kWarps) {
      float* pr = Ps + r * kBK;
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

    for (int i = tid; i < R * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const float* pr = Ps + r * kBK;
      float o = acc[i] * alpha[r];
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) o = fmaf(pr[j], Vs[j * HD + d], o);
      acc[i] = o;
    }
  }
  __syncthreads();

  const int H = gridDim.y * R;
  if (a.nsplit == 1) {
    T* ob = static_cast<T*>(a.o) + b * a.osb + kh * R * a.osh;
    for (int i = tid; i < R * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 1.f;
      ob[r * a.osh + d] = from_f32<T>(acc[i] * inv);
    }
    return;
  }
  // An empty split (past len) leaves m = -inf, l = 0, acc = 0.
  for (int i = tid; i < R * (HD + 2); i += kThreads) {
    const int r = i / (HD + 2), d = i - r * (HD + 2);
    float* p = a.part + ((static_cast<long long>(b) * H + kh * R + r) * a.nsplit + split) * (HD + 2);
    p[d] = d < HD ? acc[r * HD + d] : (d == HD ? m[r] : l[r]);
  }
}

// Merges the splits' partial sums: grid (H, B), one thread per head element.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) flash_decode_merge_kernel(DecodeArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const float* p = a.part + (static_cast<long long>(b) * gridDim.x + h) * a.nsplit * (HD + 2);
  float mx = -INFINITY;
  for (int s = 0; s < a.nsplit; ++s) mx = fmaxf(mx, p[s * (HD + 2) + HD]);
  float sum = 0.f, out = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float* ps = p + s * (HD + 2);
    const float w = ps[HD + 1] > 0.f ? __expf(ps[HD] - mx) : 0.f;
    sum += w * ps[HD + 1];
    out += w * ps[d];
  }
  T* ob = static_cast<T*>(a.o) + b * a.osb + h * a.osh;
  ob[d] = from_f32<T>(sum > 0.f ? out / sum : 0.f);
}

template <typename T, int HD>
cudaError_t launch(const DecodeArgs& a, int B, int H, int K, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<HD>(a.q_per_kv);
  cudaError_t err = allow_smem(flash_decode_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<T, HD><<<dim3(a.nsplit, K, B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  flash_decode_merge_kernel<T, HD><<<dim3(H, B), HD, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const DecodeArgs& a, int B, int H, int K, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, B, H, K, stream);
    case 32: return launch<T, 32>(a, B, H, K, stream);
    case 64: return launch<T, 64>(a, B, H, K, stream);
    case 128: return launch<T, 128>(a, B, H, K, stream);
    case 160: return launch<T, 160>(a, B, H, K, stream);
    case 256: return launch<T, 256>(a, B, H, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q (B, H, hd), k and v caches (B, S, K, hd), lengths (B,) int32 on the
// device, o (B, H, hd), each with a unit stride in its last dimension;
// strides are in elements, and rows must be 16-byte aligned.  The
// keys are cut into nsplit splits of chunk keys (a multiple of 64); with
// nsplit > 1, part is f32 scratch of B * H * nsplit * (hd + 2) floats.
// window <= 0 and cap <= 0 disable the window and the softcap.  Returns a
// cudaError_t.
extern "C" int repro_flash_decode(int dtype, int hd, const void* q, const void* k,
                                  const void* v, const int* lengths, void* o, float* part,
                                  int B, int H, int K, int S, int nsplit, int chunk,
                                  long long qsb, long long qsh, long long ksb, long long kss,
                                  long long ksh, long long vsb, long long vss, long long vsh,
                                  long long osb, long long osh, float scale, int window,
                                  float cap, void* stream) {
  using namespace repro;
  if (B <= 0) return cudaSuccess;
  if (K <= 0 || H % K != 0 || nsplit <= 0 || chunk <= 0 || chunk % kBK != 0 ||
      (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const DecodeArgs a{q,   k,   v,   lengths, o,   part, H / K, S,     nsplit, chunk, qsb,
                     qsh, ksb, kss, ksh,     vsb, vss,  vsh,   osb,   osh,    scale, cap,
                     window};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_hd<float>(hd, a, B, H, K, st);
  if (dtype == kBFloat16) return launch_hd<__nv_bfloat16>(hd, a, B, H, K, st);
  return cudaErrorInvalidValue;
}
