// masked_update: the dense-mask apply, W <- W + alpha * (M * V), in place.
//
// Replaces the TPU kernel src/repro/kernels/masked_update.py:
// masked_update_tiles (Pallas body _masked_update_kernel), which walked W,
// M and V in (256, 256) VMEM tiles of one (n, m) matrix and wrote W back
// through an input/output alias. Its path is the apply of a dense
// (mask, delta) pair: hook-mode SHiRA training's update, once a step for
// each target leaf, with V the AdamW direction and alpha = -lr.
//
// For every element, in f32, in the reference's order
// (repro.kernels.ref.masked_update_ref):
//
//   out = w + (alpha * m) * v
//
// each product and the sum rounded on its own (__fmul_rn, __fadd_rn): nvcc
// would otherwise contract the product and the sum into one FMA, and the
// kernel would not equal its plain version bit for bit. A bf16 W is
// widened exactly and the sum rounded to nearest even (__float2bfloat16_rn),
// as torch's .to(bfloat16) rounds.
//
// Instances: W f32 or bf16; M bool/uint8 (the port's masks, one byte an
// entry, read as its value 0 or 1) or f32 (the reference's masks, from the
// bridge); V f32.
//
// What bounds it on the H100: bytes. Each element reads W, M and V and
// writes W: 13 bytes with f32 W and a bool M, 16 with an f32 M, for three
// f32 operations. The whole contiguous (..., n, m) leaf is one flat array,
// so stacked (L, n, m) leaves take one launch and no shape needs to be a
// multiple of a tile (the Pallas kernel asserted n and m multiples of 256,
// a TPU tile constraint). A grid-stride loop gives each thread four
// neighbouring elements an iteration: 16-byte loads of f32 W and V, 8 bytes
// of a bf16 W, 4 mask bytes at once, so neighbouring threads read
// neighbouring addresses. The elements past the last group of four (and
// every element, when an operand is not 16-byte aligned) go through the
// scalar loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks on each of 132 SMs

__device__ __forceinline__ float apply(float w, float m, float v,
                                       float alpha) {
  return __fadd_rn(w, __fmul_rn(__fmul_rn(alpha, m), v));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Four mask values from one aligned load.
__device__ __forceinline__ float4 load4(const uint8_t* m) {
  const uchar4 q = *reinterpret_cast<const uchar4*>(m);
  return make_float4(q.x, q.y, q.z, q.w);
}
__device__ __forceinline__ float4 load4(const float* m) {
  return *reinterpret_cast<const float4*>(m);
}

// Four W values from one aligned load, and their store.
__device__ __forceinline__ float4 load4w(const float* w) {
  return *reinterpret_cast<const float4*>(w);
}
__device__ __forceinline__ float4 load4w(const __nv_bfloat16* w) {
  const uint2 raw = *reinterpret_cast<const uint2*>(w);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}
__device__ __forceinline__ void store4w(float* w, float4 x) {
  *reinterpret_cast<float4*>(w) = x;
}
__device__ __forceinline__ void store4w(__nv_bfloat16* w, float4 x) {
  __nv_bfloat162 a, b;
  a.x = __float2bfloat16_rn(x.x);
  a.y = __float2bfloat16_rn(x.y);
  b.x = __float2bfloat16_rn(x.z);
  b.y = __float2bfloat16_rn(x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(w) = raw;
}

template <typename W, typename M>
__global__ void masked_update_kernel(W* __restrict__ w,
                                     const M* __restrict__ m,
                                     const float* __restrict__ v,
                                     long long n, long long groups,
                                     float alpha) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long g = t; g < groups; g += stride) {
    const long long i = g * 4;
    const float4 wv = load4w(w + i);
    const float4 mv = load4(m + i);
    const float4 vv = *reinterpret_cast<const float4*>(v + i);
    store4w(w + i, make_float4(apply(wv.x, mv.x, vv.x, alpha),
                               apply(wv.y, mv.y, vv.y, alpha),
                               apply(wv.z, mv.z, vv.z, alpha),
                               apply(wv.w, mv.w, vv.w, alpha)));
  }
  for (long long i = groups * 4 + t; i < n; i += stride) {
    store(w + i, apply(to_f32(w[i]), to_f32(m[i]), v[i], alpha));
  }
}

template <typename W, typename M>
int launch(void* w, const void* m, const float* v, long long n, int vec,
           float alpha, cudaStream_t stream) {
  const long long groups = vec ? n / 4 : 0;
  const long long work = groups ? groups : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long capped = want < kMaxBlocks ? want : kMaxBlocks;
  const int blocks = static_cast<int>(capped > 0 ? capped : 1);
  masked_update_kernel<W, M><<<blocks, kThreads, 0, stream>>>(
      static_cast<W*>(w), static_cast<const M*>(m), v, n, groups, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w: n contiguous elements, f32 (w_dtype 0) or bf16 (1), updated in place;
// m: n mask entries, one byte each (m_dtype 0: bool or uint8) or f32 (1);
// v: n f32 values. vec = 1 when w, m and v are 16-byte aligned (then four
// elements an iteration), else 0. Returns cudaGetLastError(), or -1 for a
// dtype code it does not know.
extern "C" int masked_update_launch(void* w, const void* m, const float* v,
                                    long long n, int w_dtype, int m_dtype,
                                    int vec, float alpha, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0 && m_dtype == 0)
    return launch<float, uint8_t>(w, m, v, n, vec, alpha, s);
  if (w_dtype == 0 && m_dtype == 1)
    return launch<float, float>(w, m, v, n, vec, alpha, s);
  if (w_dtype == 1 && m_dtype == 0)
    return launch<__nv_bfloat16, uint8_t>(w, m, v, n, vec, alpha, s);
  if (w_dtype == 1 && m_dtype == 1)
    return launch<__nv_bfloat16, float>(w, m, v, n, vec, alpha, s);
  return -1;
}
