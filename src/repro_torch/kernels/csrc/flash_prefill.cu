// flash_prefill: tiled attention forward with an online softmax, causal or
// bidirectional, for GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py:
// flash_prefill_blocks (Pallas body _flash_prefill_kernel). For request b,
// query head h (KV head h / G) and query row i:
//
//   out[b, i, h] = softmax(q[b, i, h] . K[b, :, h / G] / sqrt(D)
//                          [causal: positions > i masked]) @ V[b, :, h / G]
//
// Scores, the online softmax and P.V are f32 with p kept in f32, scale =
// 1 / sqrt(D) rounded in f32 by the caller, and the output is
// acc / max(l, 1e-30) cast to q's dtype: the arithmetic of the Pallas body.
// Causal tiles above the diagonal are skipped, and the tails of Sq and Skv
// are masked rather than padded: the reference's wrapper pads both to 512
// (repro/kernels/ops.py:flash_prefill) and, bidirectional, lets the padded
// keys in, so the two agree bidirectionally only where Skv is a multiple
// of its kv block. Layouts are the model's own, read in place: q and out
// (B, Sq, H, D), k and v (B, Skv, KV, D), H = KV * G, head h = kv * G + g.
//
// What bounds it on the H100: operations. A 1024-token causal prefill of
// starcoder2-7b does ~9.7 GFLOP a layer on ~10 MB of q, k, v and out. This
// first kernel uses plain f32 FMA, not the tensor cores (mma / wgmma are a
// later step): one CTA of 256 threads per (64 query rows, query head,
// request) keeps its q tile in shared memory and walks K/V in tiles of 32
// rows. A warp owns 8 query rows' scores of a tile, one key per lane, so
// the online softmax's max and sum are warp shuffles; K rows are padded to
// D + 1 floats so the lanes' dot products hit distinct banks. Each thread
// then owns one output column for 64 / (256 / D) query rows in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 32;          // key rows per tile, one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Skv, int H, int KV, int causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // kBQ x D query rows
  float* ks = qs + kBQ * D;                  // kBK x (D + 1), padded
  float* vs = ks + kBK * (D + 1);            // kBK x D
  float* ps = vs + kBK * D;                  // kBQ x kBK probabilities
  float* ms = ps + kBQ * kBK;                // kBQ running max
  float* ls = ms + kBQ;                      // kBQ running sum
  float* cs = ls + kBQ;                      // kBQ this tile's correction

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int R = kThreads / D;            // query rows per pass
  constexpr int kRows = kBQ / R;
  const int d = tid % D;
  const int r0 = tid / D;
  const int nq = min(kBQ, Sq - q0);

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    qs[e] = r < nq ? to_f32(q[((static_cast<long long>(b) * Sq + q0 + r) * H
                               + h) * D + e % D])
                   : 0.f;
  }
  if (tid < kBQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  // keys a causal query row of this tile can see end at its last row
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  __syncthreads();

  for (int t0 = 0; t0 < kv_end; t0 += kBK) {
    const int n = min(kBK, kv_end - t0);
    for (int e = tid; e < n * D; e += kThreads) {
      const int r = e / D;
      const int dd = e % D;
      const long long off =
          ((static_cast<long long>(b) * Skv + t0 + r) * KV + hk) * D + dd;
      ks[r * (D + 1) + dd] = to_f32(k[off]);
      vs[r * D + dd] = to_f32(v[off]);
    }
    __syncthreads();
    // scores and the online softmax: warp w owns query rows w, w + 8, ...
    const float* kr = ks + lane * (D + 1);
    for (int r = warp; r < kBQ; r += kWarps) {
      const int qpos = q0 + r;
      const bool valid = r < nq && lane < n && (!causal || t0 + lane <= qpos);
      float s = kNegInf;
      if (valid) {
        const float* qr = qs + r * D;
        float dot = 0.f;
#pragma unroll 8
        for (int i = 0; i < D; ++i) dot = fmaf(qr[i], kr[i], dot);
        s = dot * scale;
      }
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ps[r * kBK + lane] = p;
      __syncwarp();                          // every lane has read ms[r]
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[r] = corr;
        ms[r] = m_new;
        ls[r] = ls[r] * corr + sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + R * i;
      float a = acc[i] * cs[r];
      const float* pr = ps + r * kBK;
      for (int c = 0; c < n; ++c) a = fmaf(pr[c], vs[c * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + R * i;
    if (r < nq) {
      store(out + ((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + d,
            acc[i] / fmaxf(ls[r], 1e-30f));
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Skv, H, KV, causal;
  float scale;
  cudaStream_t stream;
};

template <int D, typename T>
int run(const Args& a) {
  constexpr size_t smem = sizeof(float) *
      (kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK + 3 * kBQ);
  auto kernel = flash_prefill_kernel<D, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.Sq, a.Skv, a.H,
      a.KV, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(const Args& a, int D) {
  switch (D) {
    case 16: return run<16, T>(a);
    case 32: return run<32, T>(a);
    case 64: return run<64, T>(a);
    case 128: return run<128, T>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, D); k, v (B, Skv, KV, D); out (B, Sq, H, D); one dtype for
// all, f32 or bf16 (is_bf16). H a multiple of KV, D in {16, 32, 64, 128},
// causal 0 or 1. Returns cudaGetLastError() after the launch.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, int is_bf16, void* out,
                                    int B, int Sq, int Skv, int H, int KV,
                                    int D, int causal, float scale,
                                    void* stream) {
  if (KV < 1 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, Sq, Skv, H, KV, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return is_bf16 ? by_dim<__nv_bfloat16>(a, D) : by_dim<float>(a, D);
}
