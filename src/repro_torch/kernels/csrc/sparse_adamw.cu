// sparse_adamw: the fused AdamW step over packed SHiRA values.
//
// Replaces the TPU kernels src/repro/kernels/sparse_adamw.py:
//   sparse_adamw_blocks  (Pallas body _adamw_kernel): one (K,) vector;
//   sparse_adamw_rows    (Pallas body _adamw_rows_kernel): (R, K) rows, one
//                        row per (adapter, layer), with the moments stored
//                        f32, bf16, or int8 with a per-row scale.
// For every element, with scalars lr, b1, b2, eps, wd, c1 = 1 - b1^t and
// c2 = 1 - b2^t computed in f32 by the caller:
//
//   m  = b1 * m_prev + (1 - b1) * g
//   u  = b2 * u_prev + (1 - b2) * g * g
//   v' = v - lr * ((m / c1) / (sqrt(u / c2) + eps) + wd * v)
//
// v', m and u are written in f32. int8 moments decode as m_prev = q * s
// and, since nu is stored in the sqrt domain, u_prev = (q * s)^2; the
// caller re-encodes the f32 moments (repro_torch.training.qstate).
//
// Every product, quotient, sum and the square root is rounded on its own
// (__fmul_rn, __fdiv_rn, __fadd_rn, __fsqrt_rn): the compiler may not fuse
// them into FMAs, and the result follows the formula's operation order as
// the Pallas kernel's does. The plain PyTorch version runs the same f32
// operations one by one, but PyTorch divides by a scalar as a product with
// its reciprocal, so the two differ in the last bit of some elements.
//
// What bounds it on the H100: bytes. Each element reads v, g, m, u and
// writes v', m, u: 28 bytes with f32 moments, 24 with bf16, 22 with int8
// (plus two scales a row), for ~15 f32 operations (~50 instructions with
// the rounded division and square-root sequences), far below the ~20
// operations a byte at which the f32 units would bound it. The outputs are
// three fresh f32 arrays whatever the moment type, so writes are 43% of
// the bytes with f32 moments and 55% with int8; the share of the bound
// reached falls in that order.
//
// A design of one element a thread ran at its element rate, not its byte
// rate: seven 1-, 2- or 4-byte accesses an element whatever the storage
// type, and a grid of one element a thread whose blocks retired after one
// element each, so int8 moments, 22% fewer bytes than f32, took 95% of
// f32's time. This one streams:
//   - one body over n contiguous elements, n = K for a vector and R * K for
//     rows (the row matters only for int8 scales: it is computed once a
//     vector, with at most one row boundary inside, or per element where K
//     is shorter than a vector), so there is no 2-D grid and no row limit;
//   - each thread takes kVec consecutive elements as 16-byte accesses for
//     the f32 arrays (an 8-byte load of bf16 moments, 4 of int8), loads
//     through the read-only path (__ldg) and stores with the streaming
//     hint (__stcs: every byte is touched once). On the H100
//     (tools/adamw_compare.py, medians of 7 rounds) __ldg loads ran 1.0-2.6%
//     faster than streaming loads (__ldcs), blocks of 512 threads 0.5-1.7%
//     faster than 256 or 128, and vectors of 4 0.7-1.3% faster than 8
//     (72-98 registers) but for int8 moments, where the two tie;
//   - a persistent grid (the blocks that fit on every SM at once, from the
//     occupancy API, the SM count read once a device) strides over the
//     vectors, loading two vectors before it computes the first, so every
//     SM has tens of KB of loads in flight, more than its share of the
//     memory's rate times its latency (3.35 TB/s x ~1 us / 132 ~ 25 KB);
//   - the last n mod kVec elements are done one at a time in the same
//     launch. The wrapper launches the kVec-wide instance when every
//     pointer is aligned to a vector's bytes (whole tensors always are),
//     else the one-element instance of the same template.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kVec = 4;         // elements a thread-vector
constexpr int kMaxDevices = 64;

struct Scalars {
  float lr, b1, b2, eps, wd, c1, c2;
};

__device__ __forceinline__ void adamw_element(Scalars s, float v, float g,
                                              float m_prev, float u_prev,
                                              float* v_out, float* m_out,
                                              float* u_out) {
  const float m = __fadd_rn(__fmul_rn(s.b1, m_prev),
                            __fmul_rn(__fsub_rn(1.0f, s.b1), g));
  const float u = __fadd_rn(__fmul_rn(s.b2, u_prev),
                            __fmul_rn(__fmul_rn(__fsub_rn(1.0f, s.b2), g), g));
  const float mh = __fdiv_rn(m, s.c1);
  const float uh = __fdiv_rn(u, s.c2);
  const float denom = __fadd_rn(__fsqrt_rn(uh), s.eps);
  const float delta = __fadd_rn(__fdiv_rn(mh, denom), __fmul_rn(s.wd, v));
  *v_out = __fsub_rn(v, __fmul_rn(s.lr, delta));
  *m_out = m;
  *u_out = u;
}

// One element of any storage type, as f32 (exact).
__device__ __forceinline__ float load1(const float* p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(__ldg(p + i));
}
__device__ __forceinline__ float load1(const int8_t* p, long long i) {
  return static_cast<float>(
      __ldg(reinterpret_cast<const signed char*>(p) + i));
}

// The raw bits of one vector of V elements of T (V * sizeof(T) >= 4) as
// 32-bit words, in one or two loads.
template <int W>
struct Words {
  unsigned int w[W];
};
template <typename T, int V>
constexpr int kWords = static_cast<int>(V * sizeof(T) / 4);

template <typename T, int V>
__device__ __forceinline__ Words<kWords<T, V>> load_words(const T* p,
                                                          long long i) {
  constexpr int W = kWords<T, V>;
  Words<W> r;
  const void* a = p + i;
  if constexpr (W == 1) {
    r.w[0] = __ldg(static_cast<const unsigned int*>(a));
  } else if constexpr (W == 2) {
    const uint2 x = __ldg(static_cast<const uint2*>(a));
    r.w[0] = x.x, r.w[1] = x.y;
  } else {
    static_assert(W % 4 == 0, "vectors of 16-byte words");
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 x = __ldg(static_cast<const uint4*>(a) + q);
      r.w[4 * q] = x.x, r.w[4 * q + 1] = x.y;
      r.w[4 * q + 2] = x.z, r.w[4 * q + 3] = x.w;
    }
  }
  return r;
}

// Element j of a loaded vector, as f32 (exact).
template <typename T, int W>
__device__ __forceinline__ float element(const Words<W>& r, int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[j]);
  } else if constexpr (sizeof(T) == 2) {
    const unsigned int bits = (r.w[j / 2] >> (16 * (j % 2))) & 0xffffu;
    return __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(bits)));
  } else {
    const unsigned int bits = (r.w[j / 4] >> (8 * (j % 4))) & 0xffu;
    return static_cast<float>(static_cast<signed char>(bits));
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, long long i,
                                          const float (&x)[V]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q)
    __stcs(reinterpret_cast<float4*>(p + i) + q,
           make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
}

// The f32 moments of element i from their stored values (int8: q * scale,
// nu squared back from the sqrt domain).
template <bool kScaled>
__device__ __forceinline__ void decode(float& m_prev, float& u_prev, float ms,
                                       float us) {
  if (kScaled) {
    m_prev = __fmul_rn(m_prev, ms);
    const float ru = __fmul_rn(u_prev, us);
    u_prev = __fmul_rn(ru, ru);
  }
}

template <typename MT, bool kScaled>
__device__ __forceinline__ void one(const float* __restrict__ v,
                                    const float* __restrict__ g,
                                    const MT* __restrict__ mu,
                                    const MT* __restrict__ nu,
                                    const float* __restrict__ mu_scale,
                                    const float* __restrict__ nu_scale,
                                    float* __restrict__ v_out,
                                    float* __restrict__ m_out,
                                    float* __restrict__ u_out, long long i,
                                    long long k, Scalars s) {
  float m_prev = load1(mu, i), u_prev = load1(nu, i);
  if (kScaled) {
    const long long row = i / k;
    decode<true>(m_prev, u_prev, __ldg(mu_scale + row), __ldg(nu_scale + row));
  }
  float vo, mo, uo;
  adamw_element(s, load1(v, i), load1(g, i), m_prev, u_prev, &vo, &mo, &uo);
  __stcs(v_out + i, vo);
  __stcs(m_out + i, mo);
  __stcs(u_out + i, uo);
}

// The loaded operands of one vector.
template <typename MT, int V>
struct Vec {
  Words<V> v, g;
  Words<kWords<MT, V>> m, u;
};

template <typename MT, int V>
__device__ __forceinline__ Vec<MT, V> load_vec(const float* v, const float* g,
                                               const MT* mu, const MT* nu,
                                               long long i0) {
  return {load_words<float, V>(v, i0), load_words<float, V>(g, i0),
          load_words<MT, V>(mu, i0), load_words<MT, V>(nu, i0)};
}

template <typename MT, bool kScaled, int V>
__device__ __forceinline__ void update_vec(
    const Vec<MT, V>& x, const float* __restrict__ mu_scale,
    const float* __restrict__ nu_scale, float* __restrict__ v_out,
    float* __restrict__ m_out, float* __restrict__ u_out, long long i0,
    long long k, Scalars s) {
  constexpr int W = kWords<MT, V>;
  float ms[V], us[V];   // int8 scales of each element's row
#pragma unroll
  for (int j = 0; j < V; ++j) ms[j] = us[j] = 1.0f;
  if (kScaled) {
    if (k >= V) {   // at most one row boundary inside the vector
      const long long row = i0 / k;
      const long long next = (row + 1) * k;
      const float ms0 = __ldg(mu_scale + row), us0 = __ldg(nu_scale + row);
      float ms1 = ms0, us1 = us0;
      if (next < i0 + V) {
        ms1 = __ldg(mu_scale + row + 1);
        us1 = __ldg(nu_scale + row + 1);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ms[j] = i0 + j < next ? ms0 : ms1;
        us[j] = i0 + j < next ? us0 : us1;
      }
    } else {        // rows shorter than a vector
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const long long row = (i0 + j) / k;
        ms[j] = __ldg(mu_scale + row);
        us[j] = __ldg(nu_scale + row);
      }
    }
  }
  float vo[V], mo[V], uo[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float m_prev = element<MT, W>(x.m, j), u_prev = element<MT, W>(x.u, j);
    decode<kScaled>(m_prev, u_prev, ms[j], us[j]);
    adamw_element(s, __uint_as_float(x.v.w[j]), __uint_as_float(x.g.w[j]),
                  m_prev, u_prev, &vo[j], &mo[j], &uo[j]);
  }
  store_vec<V>(v_out, i0, vo);
  store_vec<V>(m_out, i0, mo);
  store_vec<V>(u_out, i0, uo);
}

// n elements, flat; the row (i / k) picks int8 scales. V = kVec needs every
// pointer aligned to V elements' bytes; V = 1 takes any.
template <typename MT, bool kScaled, int V>
__global__ void __launch_bounds__(kThreads)
adamw_stream_kernel(const float* __restrict__ v, const float* __restrict__ g,
                    const MT* __restrict__ mu, const MT* __restrict__ nu,
                    const float* __restrict__ mu_scale,
                    const float* __restrict__ nu_scale,
                    float* __restrict__ v_out, float* __restrict__ m_out,
                    float* __restrict__ u_out, long long n, long long k,
                    Scalars s) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if constexpr (V > 1) {
    const long long nvec = n / V;
    for (long long a = t; a < nvec; a += 2 * stride) {
      const long long b = a + stride;
      const Vec<MT, V> xa = load_vec<MT, V>(v, g, mu, nu, a * V);
      Vec<MT, V> xb;
      if (b < nvec) xb = load_vec<MT, V>(v, g, mu, nu, b * V);
      update_vec<MT, kScaled, V>(xa, mu_scale, nu_scale, v_out, m_out, u_out,
                                 a * V, k, s);
      if (b < nvec)
        update_vec<MT, kScaled, V>(xb, mu_scale, nu_scale, v_out, m_out,
                                   u_out, b * V, k, s);
    }
    done = nvec * V;
  }
  for (long long i = done + t; i < n; i += stride)
    one<MT, kScaled>(v, g, mu, nu, mu_scale, nu_scale, v_out, m_out, u_out, i,
                     k, s);
}

// Persistent grid: the blocks that fit on every SM at once (SM count and
// occupancy read once a device and instance), fewer if n is small.
template <typename MT, bool kScaled, int V>
unsigned int grid_for(long long n) {
  static int cached[kMaxDevices];   // blocks per device, 0 = not read yet
  int dev = 0;
  cudaGetDevice(&dev);
  int& full = cached[dev < kMaxDevices ? dev : 0];
  if (full == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adamw_stream_kernel<MT, kScaled, V>, kThreads, 0);
    full = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (n / V + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(need < 1 ? 1 : (need < full ? need : full));
}

template <typename MT, bool kScaled, int V>
int run(const float* v, const float* g, const void* mu, const void* nu,
        const float* ms, const float* us, float* v_out, float* m_out,
        float* u_out, long long n, long long k, Scalars s,
        cudaStream_t stream) {
  adamw_stream_kernel<MT, kScaled, V>
      <<<grid_for<MT, kScaled, V>(n), kThreads, 0, stream>>>(
          v, g, static_cast<const MT*>(mu), static_cast<const MT*>(nu), ms,
          us, v_out, m_out, u_out, n, k, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename MT, bool kScaled>
int run_vec(int vec, const float* v, const float* g, const void* mu,
            const void* nu, const float* ms, const float* us, float* v_out,
            float* m_out, float* u_out, long long n, long long k, Scalars s,
            cudaStream_t stream) {
  if (vec == kVec)
    return run<MT, kScaled, kVec>(v, g, mu, nu, ms, us, v_out, m_out, u_out,
                                  n, k, s, stream);
  if (vec == 1)
    return run<MT, kScaled, 1>(v, g, mu, nu, ms, us, v_out, m_out, u_out, n,
                               k, s, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Elements a vector of the wide instance: the wrapper's alignment rule.
extern "C" int sparse_adamw_vec() { return kVec; }

// values/grads/mu/nu (k,) f32; outputs (k,) f32, apart from the inputs.
// vec: kVec (every pointer aligned to kVec elements' bytes) or 1.
// Returns cudaGetLastError() after the launch.
extern "C" int sparse_adamw_launch(const float* v, const float* g,
                                   const float* mu, const float* nu,
                                   float* v_out, float* m_out, float* u_out,
                                   long long k, int vec, float lr, float b1,
                                   float b2, float eps, float wd, float c1,
                                   float c2, void* stream) {
  const Scalars s{lr, b1, b2, eps, wd, c1, c2};
  return run_vec<float, false>(vec, v, g, mu, nu, nullptr, nullptr, v_out,
                               m_out, u_out, k, k,
                               s, static_cast<cudaStream_t>(stream));
}

// values/grads (r, k) f32; mu/nu (r, k) stored as f32 (moment_mode 0),
// bf16 (1) or int8 (2, with per-row mu_scale/nu_scale (r,) f32, nu in the
// sqrt domain); outputs (r, k) f32. vec as above. Returns
// cudaGetLastError().
extern "C" int sparse_adamw_rows_launch(
    const float* v, const float* g, const void* mu, const void* nu,
    const float* mu_scale, const float* nu_scale, int moment_mode,
    float* v_out, float* m_out, float* u_out, long long r, long long k,
    int vec, float lr, float b1, float b2, float eps, float wd, float c1,
    float c2, void* stream) {
  const Scalars s{lr, b1, b2, eps, wd, c1, c2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = r * k;
  switch (moment_mode) {
    case 0:
      return run_vec<float, false>(vec, v, g, mu, nu, nullptr, nullptr,
                                   v_out, m_out, u_out, n, k, s, st);
    case 1:
      return run_vec<__nv_bfloat16, false>(vec, v, g, mu, nu, nullptr,
                                           nullptr, v_out, m_out, u_out, n, k,
                                           s, st);
    case 2:
      return run_vec<int8_t, true>(vec, v, g, mu, nu, mu_scale, nu_scale,
                                   v_out, m_out, u_out, n, k, s, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
