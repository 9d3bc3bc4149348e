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
// writes v', m, u: 28 bytes with f32 moments (22 with int8), for ~15 f32
// operations. One thread per element over a grid-stride loop, neighbouring
// threads on neighbouring elements, so every access is coalesced; the tail
// is masked and nothing is padded (the Pallas kernel needed K padded to a
// multiple of its 2048-element block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float lr, b1, b2, eps, wd, c1, c2;
};

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f32(const int8_t* p, long long i) {
  return static_cast<float>(p[i]);
}

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

__global__ void __launch_bounds__(kThreads)
adamw_blocks_kernel(const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ mu,
                    const float* __restrict__ nu, float* __restrict__ v_out,
                    float* __restrict__ m_out, float* __restrict__ u_out,
                    long long k, Scalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < k; i += stride) {
    adamw_element(s, v[i], g[i], mu[i], nu[i], v_out + i, m_out + i,
                  u_out + i);
  }
}

// Grid: x strides the K axis of a row, y is the row.
template <typename MT, bool kScaled>
__global__ void __launch_bounds__(kThreads)
adamw_rows_kernel(const float* __restrict__ v, const float* __restrict__ g,
                  const MT* __restrict__ mu, const MT* __restrict__ nu,
                  const float* __restrict__ mu_scale,
                  const float* __restrict__ nu_scale,
                  float* __restrict__ v_out, float* __restrict__ m_out,
                  float* __restrict__ u_out, long long k, Scalars s) {
  const long long row = blockIdx.y;
  const float ms = kScaled ? mu_scale[row] : 1.0f;
  const float us = kScaled ? nu_scale[row] : 1.0f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < k; j += stride) {
    const long long i = row * k + j;
    float m_prev = load_f32(mu, i);
    float u_prev = load_f32(nu, i);
    if (kScaled) {
      m_prev = __fmul_rn(m_prev, ms);
      const float ru = __fmul_rn(u_prev, us);
      u_prev = __fmul_rn(ru, ru);
    }
    adamw_element(s, v[i], g[i], m_prev, u_prev, v_out + i, m_out + i,
                  u_out + i);
  }
}

unsigned int blocks_for(long long k) {
  // enough blocks for every element, capped: the loop strides the rest
  const long long b = (k + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < 1 ? 1 : (b > 1048576 ? 1048576 : b));
}

template <typename MT, bool kScaled>
int run_rows(const float* v, const float* g, const void* mu, const void* nu,
             const float* ms, const float* us, float* v_out, float* m_out,
             float* u_out, long long r, long long k, Scalars s,
             cudaStream_t stream) {
  const dim3 grid(blocks_for(k), static_cast<unsigned int>(r));
  adamw_rows_kernel<MT, kScaled><<<grid, kThreads, 0, stream>>>(
      v, g, static_cast<const MT*>(mu), static_cast<const MT*>(nu), ms, us,
      v_out, m_out, u_out, k, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values/grads/mu/nu (k,) f32; outputs (k,) f32, apart from the inputs.
// Returns cudaGetLastError() after the launch.
extern "C" int sparse_adamw_launch(const float* v, const float* g,
                                   const float* mu, const float* nu,
                                   float* v_out, float* m_out, float* u_out,
                                   long long k, float lr, float b1, float b2,
                                   float eps, float wd, float c1, float c2,
                                   void* stream) {
  const Scalars s{lr, b1, b2, eps, wd, c1, c2};
  adamw_blocks_kernel<<<blocks_for(k), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      v, g, mu, nu, v_out, m_out, u_out, k, s);
  return static_cast<int>(cudaGetLastError());
}

// values/grads (r, k) f32; mu/nu (r, k) stored as f32 (moment_mode 0),
// bf16 (1) or int8 (2, with per-row mu_scale/nu_scale (r,) f32, nu in the
// sqrt domain); outputs (r, k) f32. Returns cudaGetLastError().
extern "C" int sparse_adamw_rows_launch(
    const float* v, const float* g, const void* mu, const void* nu,
    const float* mu_scale, const float* nu_scale, int moment_mode,
    float* v_out, float* m_out, float* u_out, long long r, long long k,
    float lr, float b1, float b2, float eps, float wd, float c1, float c2,
    void* stream) {
  const Scalars s{lr, b1, b2, eps, wd, c1, c2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (moment_mode) {
    case 0:
      return run_rows<float, false>(v, g, mu, nu, nullptr, nullptr, v_out,
                                    m_out, u_out, r, k, s, st);
    case 1:
      return run_rows<__nv_bfloat16, false>(v, g, mu, nu, nullptr, nullptr,
                                            v_out, m_out, u_out, r, k, s, st);
    case 2:
      return run_rows<int8_t, true>(v, g, mu, nu, mu_scale, nu_scale, v_out,
                                    m_out, u_out, r, k, s, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
