// flash_decode: single-query GQA decode attention, over a contiguous KV
// cache or over a page pool through per-request block tables.
//
// Replaces the TPU kernels src/repro/kernels/flash_decode.py:
// flash_decode_blocks (Pallas body _flash_decode_kernel) and
// flash_decode_paged (_flash_decode_paged_kernel). For request b, KV head h
// and each of its G query heads g:
//
//   out[b, h, g] = softmax(q[b, h, g] . K[b, :kv_len[b], h] / sqrt(D))
//                  @ V[b, :kv_len[b], h]
//
// Scores, the online softmax (running max m, sum l) and P.V are f32 with p
// kept in f32, scale = 1 / sqrt(D) rounded in f32 by the caller, and the
// output is acc / max(l, 1e-30) cast to q's dtype: the arithmetic of the
// Pallas bodies. Unlike them, kv_len is per request ((B,) int32; the
// reference takes one shared length), and the walk stops at kv_len[b]:
// blocks past a request's length are never read, so a lane engine's
// 1 K-row stripes cost what their filled part does. Contiguous caches are
// (B, S, KV, D); paged pools are (P, page, KV, D) with block_tables
// (B, nblk) mapping position t to page block_tables[b, t / page], row
// t % page. Entry 0 is the scratch page; positions >= kv_len are masked,
// so scratch entries and unwritten page tails contribute nothing. A request
// with kv_len 0 gets zeros (l stays 0; the guard keeps it finite).
//
// Layout: q (B, KV, G, D) and out (B, KV, G, D), the reference's.
//
// What bounds it on the H100: bytes. A decode step reads each K/V row once
// per KV head and does 4 * G * D flops per row, ~36 flops a byte in bf16,
// far below the card's ratio. The design: one CTA of 128 threads per
// (request, KV head) loads its G query rows once into shared memory, then
// walks K/V in tiles of 32 rows staged through shared memory as f32, so each
// K/V row is read from device memory once for all G query heads. A warp
// owns one query head's 32 scores of a tile (one per lane), so the tile's
// max and sum are warp shuffles; K rows are padded to D + 1 floats so the
// lanes' dot products hit distinct banks. Each thread then owns one of the
// D output columns for G / (128 / D) query heads, in registers. G need not
// be a power of two (starcoder2-7b has G = 9). B * KV CTAs (32 for the
// serving batch) leave most of the 132 SMs idle: splitting the walk over
// CTAs (split-K) is the next step, not taken here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // K/V rows per tile, one per lane
constexpr int kMaxG = 16;        // query heads per KV head
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

// S_or_page: the cache's rows per request (contiguous) or the page size
// (paged); nblk: block-table entries per request (paged only).
template <int D, typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    const int* __restrict__ block_tables, T* __restrict__ out,
                    int KV, int G, int S_or_page, int nblk, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // G x D query rows
  float* ks = qs + G * D;                    // kTile x (D + 1), padded
  float* vs = ks + kTile * (D + 1);          // kTile x D
  float* ps = vs + kTile * D;                // G x kTile probabilities
  float* ms = ps + G * kTile;                // G running max
  float* ls = ms + G;                        // G running sum
  float* cs = ls + G;                        // G this tile's correction

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int R = kThreads / D;            // query heads per pass
  constexpr int kRows = (kMaxG + R - 1) / R;
  const int d = tid % D;
  const int g0 = tid / D;

  const long long qbase = (static_cast<long long>(b) * KV + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(q[qbase + i]);
  if (tid < G) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  const int total = kPaged ? nblk * S_or_page : S_or_page;
  const int len = min(kv_len[b], total);
  const int* bt = kPaged ? block_tables + static_cast<long long>(b) * nblk
                         : nullptr;

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    for (int e = tid; e < n * D; e += kThreads) {
      const int r = e / D;
      const int dd = e % D;
      const int pos = t0 + r;
      long long row;
      if (kPaged) {
        row = static_cast<long long>(bt[pos / S_or_page]) * S_or_page +
              pos % S_or_page;
      } else {
        row = static_cast<long long>(b) * S_or_page + pos;
      }
      const long long off = (row * KV + h) * D + dd;
      ks[r * (D + 1) + dd] = to_f32(k[off]);
      vs[r * D + dd] = to_f32(v[off]);
    }
    __syncthreads();
    // scores and the online softmax: warp w owns query heads w, w + 4, ...
    for (int g = warp; g < G; g += kWarps) {
      float s = kNegInf;
      if (lane < n) {
        const float* qr = qs + g * D;
        const float* kr = ks + lane * (D + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int i = 0; i < D; ++i) dot = fmaf(qr[i], kr[i], dot);
        s = dot * scale;
      }
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ps[g * kTile + lane] = p;
      __syncwarp();                          // every lane has read ms[g]
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[g] = corr;
        ms[g] = m_new;
        ls[g] = ls[g] * corr + sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int g = g0 + R * i;
      if (g < G) {
        float a = acc[i] * cs[g];
        const float* pr = ps + g * kTile;
        for (int c = 0; c < n; ++c) a = fmaf(pr[c], vs[c * D + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int g = g0 + R * i;
    if (g < G) {
      store(out + qbase + static_cast<long long>(g) * D + d,
            acc[i] / fmaxf(ls[g], 1e-30f));
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  const int* block_tables;
  void* out;
  int B, KV, G, S_or_page, nblk;
  float scale;
  cudaStream_t stream;
};

template <int D, typename T, bool kPaged>
int run(const Args& a) {
  const size_t smem = sizeof(float) *
      (a.G * D + kTile * (D + 1) + kTile * D + a.G * kTile + 3 * a.G);
  auto kernel = flash_decode_kernel<D, T, kPaged>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.KV, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.kv_len, a.block_tables,
      static_cast<T*>(a.out), a.KV, a.G, a.S_or_page, a.nblk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int by_paged(const Args& a) {
  return a.block_tables != nullptr ? run<D, T, true>(a)
                                   : run<D, T, false>(a);
}

template <typename T>
int by_dim(const Args& a, int D) {
  switch (D) {
    case 16: return by_paged<16, T>(a);
    case 32: return by_paged<32, T>(a);
    case 64: return by_paged<64, T>(a);
    case 128: return by_paged<128, T>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, KV, G, D); k, v (B, S, KV, D) contiguous caches, or (P, page, KV, D)
// pools when block_tables (B, nblk) int32 is not null (then S_or_page is the
// page size); kv_len (B,) int32; out (B, KV, G, D). q, k, v and out share
// one dtype, f32 or bf16 (is_bf16). D in {16, 32, 64, 128}, G <= 16.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, int is_bf16,
                                   const int* kv_len,
                                   const int* block_tables, void* out, int B,
                                   int KV, int G, int D, int S_or_page,
                                   int nblk, float scale, void* stream) {
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, kv_len, block_tables, out, B, KV, G, S_or_page,
               nblk, scale, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? by_dim<__nv_bfloat16>(a, D) : by_dim<float>(a, D);
}
