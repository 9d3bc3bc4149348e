// flash_decode: single-query GQA decode attention, over a contiguous KV
// cache or over a page pool through per-request block tables, both
// split-K over the request's positions.
//
// Replaces the TPU kernels src/repro/kernels/flash_decode.py:
// flash_decode_blocks (Pallas body _flash_decode_kernel) and
// flash_decode_paged (_flash_decode_paged_kernel). For request b, KV head h
// and each of its G query heads g:
//
//   out[b, h, g] = softmax(q[b, h, g] . K[b, :kv_len[b], h] / sqrt(D))
//                  @ V[b, :kv_len[b], h]
//
// Scores, the softmax (max m, sum l) and P.V are f32 with p kept in f32
// (in bf16 to ~16 mantissa bits, below), scale = 1 / sqrt(D) rounded in
// f32 by the caller, and the output is acc / max(l, 1e-30) cast to q's
// dtype (by div.approx, within 2 ulp): the arithmetic of the
// Pallas bodies. Unlike them, kv_len is per request ((B,) int32; the
// reference takes one shared length), and rows at or past kv_len[b] are
// never read, so a lane engine's 1 K-row stripes cost what their filled
// part does.
// Contiguous caches are (B, S, KV, D); paged pools are (P, page, KV, D)
// with block_tables (B, nblk) mapping position t to page
// block_tables[b, t / page], row t % page. Entry 0 is the scratch page;
// positions >= kv_len are masked, so scratch entries and unwritten page
// tails contribute nothing. A request with kv_len 0 gets zeros.
// The log-sum-exp instance (contiguous caches; sequence-sharded serving,
// where each rank attends its own shard of the cache and the ranks then
// merge their softmaxes): the output, acc / l as above, is f32 whatever q's
// dtype, so that the ranks merge in f32 and round once, and beside it
// lse[b, h, g] = m + log(l) in f32 and natural-log units, from the max and
// sum the split-K merge (or the one working split) already holds. A request
// with kv_len 0 gets zeros and lse -inf, which weigh nothing in the merge.
// int8 pools (the reference's QuantKV pages, src/repro/serving/kvcache.py):
// codes (P, page, KV, D) int8 and one bf16 absmax scale per (row, head),
// scales (P, page, KV, 1). A CTA reads its rows' codes in 16-byte loads
// and their scales, and dequantizes each entry once into shared memory as
// the reference's dequantize_kv does: the f32 product code * scale rounded
// to bf16 (bf16 rows for the tensor-core kernel; the same bf16 values as
// f32 for the f32 kernel, which attends f32 q against them). Everything
// after the load is the bf16 or f32 kernel unchanged. The rows cost
// D + 2 bytes a head where bf16 pools cost 2 D.
//
// Layout: q (B, KV, G, D) and out (B, KV, G, D), the reference's.
//
// What bounds it on the H100: bytes. A decode step reads each K/V row once
// per KV head and does 4 * G * D flops on its 4 * D bytes (bf16), G flops a
// byte (9 for starcoder2-7b), far below the card's ratio even at f32's 67
// TFLOP/s. So the design has to keep enough rows in flight on all 132 SMs.
//
// Split-K, contiguous caches and page pools alike: one CTA of 128 threads
// per (split of kSplit = 64 positions, KV head, request), so a (8, 4) batch
// over a 1056-row cache is 17 x 32 CTAs, and a split that starts at or past
// kv_len[b] exits before reading anything: the grid follows the cache's
// width (S, or a pool's nblk * page), never kv_len, and the host never
// reads kv_len or the block tables. A paged CTA looks up the pool row of
// each of its positions in the request's block-table row, one position at
// a time (bt[t / page] * page + t % page), so any page size works and a
// split may span pages unevenly; a contiguous CTA reads rows b * S + t.
// Either way it copies its K and V rows into shared memory in their
// storage type with 16-byte cp.async copies, once, and serves all G query
// heads from them in groups of kGroup = 16 (any G). bf16
// (flash_decode_mma_kernel): the group's q rows are the A operand of
// mma.sync m16n8k16, so each warp scores 16 keys for all 16 heads at once
// (exact bf16 products summed in f32), the split's max and sum cross the
// warps through shared memory, and p . V runs on the tensor cores with p
// split into bf16 hi + lo as in flash_prefill (p to ~16 mantissa bits).
// f32 (flash_decode_f32_kernel, the f32 consistency runs): plain FMA, each
// thread dotting a cache row with up to 8 heads' q rows and accumulating
// p . V for one column pair of its heads. Each split writes f32 partials
// (acc[G][D], m[G], l[G]) to scratch from the wrapper; the last CTA of each
// (request, KV head) to finish, found by an atomic ticket, merges its
// working splits (acc and l scaled by exp(m_s - max m)) and resets the
// ticket for the next launch: one launch a call. A request whose kv_len
// fits one split writes its output directly. The paged engine's tables
// are wide (320 entries of 16 rows: 80 splits a request) and most of their
// CTAs exit at once, before any load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tile_ops.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;       // positions per CTA
constexpr int kGroup = 16;       // query heads per pass
constexpr float kLn2 = 0.69314718055994531f;
static_assert(2 * kSplit == kThreads, "a thread per (row, head parity)");
// The split-K kernels' launch bounds name a minimum of one CTA an SM:
// without it ptxas spills registers at some D to raise occupancy.

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

// The cache row that holds position t of request b: row b * S + t of a
// contiguous (B, S, KV, D) cache, or row t % page of page bt[t / page] of a
// (P, page, KV, D) pool, bt being the request's block-table row.
template <bool kPaged>
__device__ __forceinline__ long long cache_row(const int* bt, int page, int b,
                                               int S, int t) {
  if (kPaged) return static_cast<long long>(__ldg(bt + t / page)) * page +
                     t % page;
  return static_cast<long long>(b) * S + t;
}

// byte j of w as a signed code, times the scale, in f32 (exact: a code
// has 8 bits, a bf16 scale 8 of mantissa)
__device__ __forceinline__ float code_times(int w, int j, float s) {
  const int c = static_cast<int>(static_cast<unsigned>(w) << (24 - 8 * j)) >>
                24;
  return static_cast<float>(c) * s;
}

// 16 dequantized entries from the codes of one 16-byte chunk, each the f32
// product code * scale rounded to bf16 (dequantize_kv's rounding): into a
// row of bf16 (two 16-byte stores) or of f32 (four)
__device__ __forceinline__ void store_dequant(__nv_bfloat16* dst, int4 codes,
                                              float s) {
  const int w[4] = {codes.x, codes.y, codes.z, codes.w};
  uint32_t out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(
        code_times(w[j / 2], 2 * (j % 2), s),
        code_times(w[j / 2], 2 * (j % 2) + 1, s));
    out[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(out[0], out[1], out[2],
                                                out[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(out[4], out[5], out[6],
                                                out[7]);
}
__device__ __forceinline__ void store_dequant(float* dst, int4 codes,
                                              float s) {
  const int w[4] = {codes.x, codes.y, codes.z, codes.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = __bfloat162float(__float2bfloat16_rn(code_times(w[i], j, s)));
    reinterpret_cast<float4*>(dst)[i] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

__device__ __forceinline__ float load_scale(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

// The split's rows t0 .. t0 + kSplit of an int8 pool, dequantized into the
// shared rows ks and vs (row stride LD entries of T); rows at or past n
// are zeros. Thread tid takes 16-byte chunk tid % (D / 16) of rows
// tid / (D / 16), + kThreads / (D / 16), ...: the codes in one 16-byte
// load, the row's scale in one 2-byte load, both through the read-only
// path, all of the thread's loads issued before the first store.
template <int D, bool kPaged, typename T>
__device__ __forceinline__ void load_q8_rows(
    T* ks, T* vs, int LD, const signed char* __restrict__ kc,
    const __nv_bfloat16* __restrict__ ksc, const signed char* __restrict__ vc,
    const __nv_bfloat16* __restrict__ vsc, const int* bt, int page, int b,
    int S, int t0, int n, int KV, int h) {
  constexpr int kC = D / 16;                // 16-byte chunks of codes a row
  constexpr int kStep = kThreads / kC;
  constexpr int kPer = (kSplit + kStep - 1) / kStep;
  const int cr = threadIdx.x / kC;
  const int ce = threadIdx.x % kC * 16;
  int4 kx[kPer], vx[kPer];
  float sk[kPer], sv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = cr + i * kStep;
    kx[i] = vx[i] = make_int4(0, 0, 0, 0);
    sk[i] = sv[i] = 0.f;
    if (r < kSplit && r < n) {
      const long long row = cache_row<kPaged>(bt, page, b, S, t0 + r) * KV + h;
      kx[i] = __ldg(reinterpret_cast<const int4*>(kc + row * D + ce));
      vx[i] = __ldg(reinterpret_cast<const int4*>(vc + row * D + ce));
      sk[i] = load_scale(ksc + row);
      sv[i] = load_scale(vsc + row);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = cr + i * kStep;
    if (r < kSplit) {
      store_dequant(ks + r * LD + ce, kx[i], sk[i]);
      store_dequant(vs + r * LD + ce, vx[i], sv[i]);
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Split s of request b, KV head h writes, in part's block (bh, s) of
// G * (D + 2) floats, acc[G][D] (unnormalized p . V), then m[G] and l[G],
// m in the units the kernel's exponential takes (kLog2: scores times
// log2(e), for exp2f; else expf's). After the block's stores, each working
// split takes a ticket; the last of the nwork to finish merges them all
// into o = out[b, h] and resets the ticket to 0 for the next launch. Warp w
// merges heads w, w + 4, ..., kMergeHeads of them at once so that their
// loads overlap; lane j holds split s0 + j's m, l and weight
// exp(m_s - max m), and column pairs j, j + 32, ... kLse: lane 0 also
// writes lo[g] = max m + log(sum l), in natural-log units.
constexpr int kMergeHeads = 4;
template <int D, bool kLog2, bool kLse, typename T>
__device__ __forceinline__ void merge_if_last(const float* part,
                                              int* tickets, T* o, float* lo,
                                              int G, int nwork, int nsplit,
                                              long long bh) {
  constexpr int kPairs = D / 2;
  constexpr int kPL = (kPairs + 31) / 32;   // column pairs a lane
  constexpr int kH = kMergeHeads;
  __shared__ int last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(tickets + bh, 1) == nwork - 1;
    if (last) tickets[bh] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int stride = G * (D + 2);
  const float* pbh = part + bh * nsplit * stride;
  for (int g0 = warp; g0 < G; g0 += kWarps * kH) {
    const int nh = min(kH, (G - g0 + kWarps - 1) / kWarps);
    float m_own[kH], l_own[kH], m[kH], l[kH], a0[kH][kPL], a1[kH][kPL];
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      const float* ml = pbh + lane * stride + G * D + g0 + kWarps * i;
      const bool in = i < nh && lane < nwork;
      m_own[i] = in ? __ldcg(ml) : -INFINITY;
      l_own[i] = in ? __ldcg(ml + G) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      m[i] = m_own[i];
      for (int s = lane + 32; i < nh && s < nwork; s += 32)
        m[i] = fmaxf(m[i], __ldcg(pbh + s * stride + G * D + g0 +
                                  kWarps * i));
      m[i] = warp_max(m[i]);
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kPL; ++c) a0[i][c] = a1[i][c] = 0.f;
    }
    for (int s0 = 0; s0 < nwork; s0 += 32) {
      float w[kH];
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        w[i] = 0.f;
        if (i < nh && s0 + lane < nwork) {
          const float* ml =
              pbh + (s0 + lane) * stride + G * D + g0 + kWarps * i;
          const float x = (s0 ? __ldcg(ml) : m_own[i]) - m[i];
          w[i] = kLog2 ? exp2f(x) : expf(x);
          l[i] = fmaf(w[i], s0 ? __ldcg(ml + G) : l_own[i], l[i]);
        }
      }
      const int ns = min(32, nwork - s0);
#pragma unroll 4
      for (int j = 0; j < ns; ++j) {
#pragma unroll
        for (int i = 0; i < kH; ++i) {
          const float wj = __shfl_sync(0xffffffffu, w[i], j);
          if (i >= nh) continue;
          const float2* acc = reinterpret_cast<const float2*>(
              pbh + (s0 + j) * stride + (g0 + kWarps * i) * D);
#pragma unroll
          for (int c = 0; c < kPL; ++c) {
            if (lane + 32 * c < kPairs) {
              const float2 x = __ldcg(acc + lane + 32 * c);
              a0[i][c] = fmaf(wj, x.x, a0[i][c]);
              a1[i][c] = fmaf(wj, x.y, a1[i][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      const float lt = warp_sum(l[i]);
      const float d = fmaxf(lt, 1e-30f);
      if (i >= nh) continue;
      if constexpr (kLse) {
        if (lane == 0)
          lo[g0 + kWarps * i] = (kLog2 ? m[i] * kLn2 : m[i]) + logf(lt);
      }
      T* og = o + (g0 + kWarps * i) * D;
#pragma unroll
      for (int c = 0; c < kPL; ++c) {
        const int cp = lane + 32 * c;
        if (cp < kPairs)
          store_pair(og + 2 * cp, __fdividef(a0[i][c], d),
                     __fdividef(a1[i][c], d));
      }
    }
  }
}

// bf16 caches: the tensor cores. Per group of kGroup heads (rows of the
// mma's A, past G zero), warp w scores keys 16 w .. 16 w + 15 against all
// of them (S = q . K^T, mma.sync, exact products summed in f32); the row
// max and sum cross the warps through shared memory; p, split into bf16
// hi + lo, goes to shared memory as the A operand of P . V, of which warp
// w computes column tiles w * kNTW .. (V by ldmatrix.trans). S is the
// positions a request can hold: the cache's rows, or a pool's nblk * page.
//
// kQ8: the pools are int8 codes with bf16 scales (k_scale, v_scale),
// dequantized into the same shared rows by load_q8_rows. kLse: the output is
// f32 and lse (B, KV, G) f32 is written beside it.
template <int D, bool kPaged, bool kQ8, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const void* __restrict__ k,
                        const void* __restrict__ v,
                        const __nv_bfloat16* __restrict__ k_scale,
                        const __nv_bfloat16* __restrict__ v_scale,
                        const int* __restrict__ kv_len,
                        const int* __restrict__ block_tables,
                        std::conditional_t<kLse, float, __nv_bfloat16>*
                            __restrict__ out,
                        float* __restrict__ lse,
                        float* __restrict__ part, int* __restrict__ tickets,
                        int KV, int G, int S, int page, int nblk, int nsplit,
                        float scale) {
  constexpr int LD = D + 8;                 // a K/V/q row, padded 16 bytes
  constexpr int kChunks = D / 8;            // 16-byte chunks a row
  constexpr int kRowStep = kThreads / kChunks;
  // every thread copies (D = 16, 32, 64, 128, 256: 4 rows a pass at 256,
  // 16 B a thread); else (D = 80: 12 rows a pass over 120 threads) the
  // threads past kRowStep * kChunks copy nothing, so that each row has one
  // owner
  constexpr bool kAllCopy = kRowStep * kChunks == kThreads;
  constexpr int kPLD = kSplit + 8;          // a row of p, padded 16 bytes
  constexpr int kNT = D / 8;                // output column tiles
  constexpr int kNTW = (kNT + kWarps - 1) / kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kSplit * LD;
  __nv_bfloat16* qs = vs + kSplit * LD;     // kGroup x LD
  __nv_bfloat16* phi = qs + kGroup * LD;    // kGroup x kPLD
  __nv_bfloat16* plo = phi + kGroup * kPLD;
  float* rmax = reinterpret_cast<float*>(plo + kGroup * kPLD);  // [w][row]
  float* rsum = rmax + kWarps * kGroup;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int qd = lane & 3;
  const int len = max(0, min(kv_len[b], S));
  const int nwork = (len + kSplit - 1) / kSplit;
  const long long bh = static_cast<long long>(b) * KV + h;
  auto* o = out + bh * G * D;
  float* lo = kLse ? lse + bh * G : nullptr;
  if (split >= max(nwork, 1)) return;
  if (nwork == 0) {                         // kv_len 0: zeros (lse -inf)
    for (int i = tid; i < G * D; i += kThreads) store(o + i, 0.f);
    if constexpr (kLse)
      for (int i = tid; i < G; i += kThreads) lo[i] = -INFINITY;
    return;
  }
  const int t0 = split * kSplit;
  const int n = min(kSplit, len - t0);
  const int cr = tid / kChunks;             // this thread's copies: rows
  const int ce = tid % kChunks * 8;         // cr + i kRowStep, column ce
  const bool copier = kAllCopy || cr < kRowStep;
  const int* bt = kPaged ? block_tables + static_cast<long long>(b) * nblk
                         : nullptr;
  if constexpr (kQ8) {
    load_q8_rows<D, kPaged>(ks, vs, LD, static_cast<const signed char*>(k),
                            k_scale, static_cast<const signed char*>(v),
                            v_scale, bt, page, b, S, t0, n, KV, h);
  } else if (copier) {
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
#pragma unroll
    for (int r = cr; r < kSplit; r += kRowStep) {
      const bool ok = r < n;                // rows past the length read 0
      const long long at =
          ok ? (cache_row<kPaged>(bt, page, b, S, t0 + r) * KV + h) * D + ce
             : 0;
      cp_async16(smem_addr(ks + r * LD + ce), kb + at, ok);
      cp_async16(smem_addr(vs + r * LD + ce), vb + at, ok);
    }
  }
  auto load_q = [&](int g0) {               // heads past G read as 0
    if (!copier) return;
#pragma unroll
    for (int r = cr; r < kGroup; r += kRowStep) {
      const bool ok = g0 + r < G;
      cp_async16(smem_addr(qs + r * LD + ce),
                 q + (ok ? (bh * G + g0 + r) * D + ce : 0), ok);
    }
  };
  load_q(0);
  cp_async_commit();
  const float sl2 = scale * 1.44269504088896341f;
  const bool direct = nwork == 1;
  float* pb = part + (bh * nsplit + split) * G * (D + 2);

  for (int g0 = 0; g0 < G; g0 += kGroup) {
    const int ng = min(kGroup, G - g0);
    if (g0 > 0) {
      load_q(g0);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    float s[2][4] = {};                     // keys 16 w + 8 j + ..
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], kb[4];
      ldmatrix_x4(a, smem_addr(qs + (lane & 15) * LD + kk * 16 +
                               (lane >> 4) * 8));
      ldmatrix_x4(kb, smem_addr(ks + (warp * 16 + (lane >> 4) * 8 +
                                      (lane & 7)) * LD +
                                kk * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16(s[0], a, kb[0], kb[1]);
      mma_bf16(s[1], a, kb[2], kb[3]);
    }
    // scores in units of log2; key 0 is valid, so every row's max is finite
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = warp * 16 + j * 8 + qd * 2 + (e & 1);
        s[j][e] = key < n ? s[j][e] * sl2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    if (qd == 0) {
      rmax[warp * kGroup + grp] = mx0;
      rmax[warp * kGroup + grp + 8] = mx1;
    }
    __syncthreads();
    float m0 = rmax[grp], m1 = rmax[grp + 8];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      m0 = fmaxf(m0, rmax[w * kGroup + grp]);
      m1 = fmaxf(m1, rmax[w * kGroup + grp + 8]);
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
      const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      const int col = warp * 16 + j * 8 + qd * 2;
      uint32_t hi, lo;
      split_bf16(p0, p1, hi, lo);
      *reinterpret_cast<uint32_t*>(phi + grp * kPLD + col) = hi;
      *reinterpret_cast<uint32_t*>(plo + grp * kPLD + col) = lo;
      split_bf16(p2, p3, hi, lo);
      *reinterpret_cast<uint32_t*>(phi + (grp + 8) * kPLD + col) = hi;
      *reinterpret_cast<uint32_t*>(plo + (grp + 8) * kPLD + col) = lo;
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    if (qd == 0) {
      rsum[warp * kGroup + grp] = sum0;
      rsum[warp * kGroup + grp + 8] = sum1;
    }
    __syncthreads();
    float acc[kNTW][4] = {};
#pragma unroll
    for (int kk = 0; kk < kSplit / 16; ++kk) {
      uint32_t ah[4], al[4];
      const int pa = (lane & 15) * kPLD + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(ah, smem_addr(phi + pa));
      ldmatrix_x4(al, smem_addr(plo + pa));
#pragma unroll
      for (int i = 0; i < kNTW; ++i) {
        const int nt = warp * kNTW + i;
        if (nt < kNT) {
          uint32_t vb[2];
          ldmatrix_x2_trans(vb, smem_addr(vs + (kk * 16 + (lane & 15)) * LD +
                                          nt * 8));
          mma_bf16(acc[i], ah, vb[0], vb[1]);
          mma_bf16(acc[i], al, vb[0], vb[1]);
        }
      }
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      l0 += rsum[w * kGroup + grp];
      l1 += rsum[w * kGroup + grp + 8];
    }
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      const int col = (warp * kNTW + i) * 8 + qd * 2;
      if (warp * kNTW + i >= kNT) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int g = grp + 8 * half;
        if (g >= ng) continue;
        const float x = acc[i][2 * half], y = acc[i][2 * half + 1];
        if (direct) {
          const float d = fmaxf(half ? l1 : l0, 1e-30f);
          store_pair(o + (g0 + g) * D + col, __fdividef(x, d),
                     __fdividef(y, d));
        } else {
          *reinterpret_cast<float2*>(pb + (g0 + g) * D + col) =
              make_float2(x, y);
        }
      }
    }
    if ((!direct || kLse) && tid < ng) {
      float m = rmax[tid], l = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        m = fmaxf(m, rmax[w * kGroup + tid]);
        l += rsum[w * kGroup + tid];
      }
      if (!direct) {
        pb[G * D + g0 + tid] = m;
        pb[G * D + G + g0 + tid] = l;
      } else if constexpr (kLse) {
        lo[g0 + tid] = m * kLn2 + logf(l);  // m in units of log2
      }
    }
    __syncthreads();                        // q, p and the sums are reused
  }
  if (!direct)
    merge_if_last<D, true, kLse>(part, tickets, o, lo, G, nwork, nsplit, bh);
}

// f32 caches: plain f32 FMA, which the 1e-5 check of the f32 consistency
// runs needs. Per group of kGroup heads (q rows in shared memory as f32),
// thread (row r, parity hp) dots cache row r with heads hp, hp + 2, ...;
// a warp per head takes the split's max and sum; thread (column pair cp,
// head lane hl) accumulates p . V for heads hl, hl + R, ... in registers.
// kLse: lse (B, KV, G) is written beside the output.
template <int D, bool kPaged, bool kQ8, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_f32_kernel(const float* __restrict__ q,
                        const void* __restrict__ k,
                        const void* __restrict__ v,
                        const __nv_bfloat16* __restrict__ k_scale,
                        const __nv_bfloat16* __restrict__ v_scale,
                        const int* __restrict__ kv_len,
                        const int* __restrict__ block_tables,
                        float* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ part,
                        int* __restrict__ tickets, int KV, int G, int S,
                        int page, int nblk, int nsplit, float scale) {
  constexpr int LD = D + 4;                 // a shared row, padded 16 bytes
  constexpr int kChunks = D / 4;            // 16-byte chunks a row
  constexpr int kPairs = D / 2;             // P.V: a thread per column pair
  constexpr int R = kThreads / kPairs;      // ... and head lane
  constexpr int kPer = (kGroup + R - 1) / R;
  // every thread owns a (column pair, head lane) (D = 16, 32, 64, 128, 256);
  // else (D = 80: 3 head lanes over 120 threads) the threads past
  // R * kPairs own none, so that each output has one owner
  constexpr bool kAllPV = R * kPairs == kThreads;
  constexpr int kPS = kSplit + 4;           // a row of ps, float4-aligned
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // kSplit x LD
  float* vs = ks + kSplit * LD;             // kSplit x LD
  float* qs = vs + kSplit * LD;             // kGroup x D
  float* ps = qs + kGroup * D;              // kGroup x kPS scores, then p
  float* ml = ps + kGroup * kPS;            // kGroup max, then kGroup sum

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = max(0, min(kv_len[b], S));
  const int nwork = (len + kSplit - 1) / kSplit;
  const long long bh = static_cast<long long>(b) * KV + h;
  float* o = out + bh * G * D;
  float* lo = kLse ? lse + bh * G : nullptr;
  if (split >= max(nwork, 1)) return;
  if (nwork == 0) {                         // kv_len 0: zeros (lse -inf)
    for (int i = tid; i < G * D; i += kThreads) o[i] = 0.f;
    if constexpr (kLse)
      for (int i = tid; i < G; i += kThreads) lo[i] = -INFINITY;
    return;
  }
  const int t0 = split * kSplit;
  const int n = min(kSplit, len - t0);
  const int* bt = kPaged ? block_tables + static_cast<long long>(b) * nblk
                         : nullptr;
  if constexpr (kQ8) {
    load_q8_rows<D, kPaged>(ks, vs, LD, static_cast<const signed char*>(k),
                            k_scale, static_cast<const signed char*>(v),
                            v_scale, bt, page, b, S, t0, n, KV, h);
  } else {
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    for (int c = tid; c < kSplit * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int e = c % kChunks * 4;
      const bool ok = r < n;                // rows past the length read 0
      const long long at =
          ok ? (cache_row<kPaged>(bt, page, b, S, t0 + r) * KV + h) * D + e
             : 0;
      cp_async16(smem_addr(ks + r * LD + e), kf + at, ok);
      cp_async16(smem_addr(vs + r * LD + e), vf + at, ok);
    }
  }
  cp_async_commit();
  const bool direct = nwork == 1;
  float* pb = part + (bh * nsplit + split) * G * (D + 2);

  for (int g0 = 0; g0 < G; g0 += kGroup) {
    const int ng = min(kGroup, G - g0);
    const float4* qg = reinterpret_cast<const float4*>(q + (bh * G + g0) * D);
    for (int i = tid; i < ng * D / 4; i += kThreads)
      reinterpret_cast<float4*>(qs)[i] = qg[i];
    if (g0 == 0) cp_async_wait<0>();
    __syncthreads();
    {  // scores: thread (row r, parity hp) takes heads hp, hp + 2, ...
      const int r = tid % kSplit;
      const int hp = tid / kSplit;
      float dot[kGroup / 2];
#pragma unroll
      for (int i = 0; i < kGroup / 2; ++i) dot[i] = 0.f;
      const float* kr = ks + r * LD;
#pragma unroll 2
      for (int c = 0; c < kChunks; ++c) {
        const float4 kx = *reinterpret_cast<const float4*>(kr + c * 4);
#pragma unroll
        for (int i = 0; i < kGroup / 2; ++i) {
          if (hp + 2 * i < ng) {
            const float4 qv = *reinterpret_cast<const float4*>(
                qs + (hp + 2 * i) * D + c * 4);
            dot[i] = fmaf(qv.x, kx.x, dot[i]);
            dot[i] = fmaf(qv.y, kx.y, dot[i]);
            dot[i] = fmaf(qv.z, kx.z, dot[i]);
            dot[i] = fmaf(qv.w, kx.w, dot[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup / 2; ++i)
        if (hp + 2 * i < ng)
          ps[(hp + 2 * i) * kPS + r] = r < n ? dot[i] * scale : -INFINITY;
    }
    __syncthreads();
    // the split's softmax: warp w takes heads w, w + 4, ...; row 0 of a
    // working split is valid, so m is finite and masked rows get p = 0
    for (int g = warp; g < ng; g += kWarps) {
      float* pr = ps + g * kPS;
      const float s0 = pr[lane];
      const float s1 = pr[lane + 32];
      const float m = warp_max(fmaxf(s0, s1));
      const float p0 = expf(s0 - m);
      const float p1 = expf(s1 - m);
      const float l = warp_sum(p0 + p1);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      if (lane == 0) {
        ml[g] = m;
        ml[kGroup + g] = l;
      }
    }
    __syncthreads();
    {  // P.V: thread (column pair cp, head lane hl) takes heads hl, hl + R
      const int cp = tid % kPairs;
      const int hl = kAllPV || tid < R * kPairs ? tid / kPairs : kGroup;
      float a0[kPer], a1[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a0[i] = a1[i] = 0.f;
      // rows past n add 0: their p is 0 and their V rows are zeros
#pragma unroll 2
      for (int r = 0; r < kSplit; r += 4) {
        float2 vv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          vv[j] = *reinterpret_cast<const float2*>(vs + (r + j) * LD +
                                                   2 * cp);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (hl + R * i < ng) {
            const float4 p =
                *reinterpret_cast<const float4*>(ps + (hl + R * i) * kPS + r);
            a0[i] = fmaf(p.x, vv[0].x, a0[i]);
            a1[i] = fmaf(p.x, vv[0].y, a1[i]);
            a0[i] = fmaf(p.y, vv[1].x, a0[i]);
            a1[i] = fmaf(p.y, vv[1].y, a1[i]);
            a0[i] = fmaf(p.z, vv[2].x, a0[i]);
            a1[i] = fmaf(p.z, vv[2].y, a1[i]);
            a0[i] = fmaf(p.w, vv[3].x, a0[i]);
            a1[i] = fmaf(p.w, vv[3].y, a1[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int g = hl + R * i;
        if (g < ng) {
          const int at = (g0 + g) * D + 2 * cp;
          if (direct) {
            const float d = fmaxf(ml[kGroup + g], 1e-30f);
            store_pair(o + at, __fdividef(a0[i], d), __fdividef(a1[i], d));
          } else {
            store_pair(pb + at, a0[i], a1[i]);
          }
        }
      }
      if (!direct && tid < ng) {
        pb[G * D + g0 + tid] = ml[tid];
        pb[G * D + G + g0 + tid] = ml[kGroup + tid];
      }
      if constexpr (kLse) {
        if (direct && tid < ng)
          lo[g0 + tid] = ml[tid] + logf(ml[kGroup + tid]);
      }
    }
    __syncthreads();                        // qs, ps, ml are reused next
  }
  if (!direct)
    merge_if_last<D, false, kLse>(part, tickets, o, lo, G, nwork, nsplit, bh);
}

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;          // int8 pools only
  const void* v_scale;
  const int* kv_len;
  const int* block_tables;      // paged only
  void* out;
  float* lse;                   // the log-sum-exp instance only
  float* part;
  int* tickets;
  int B, KV, G, S, page, nblk, nsplit;
  float scale;
  cudaStream_t stream;
};

// The splits of a request that can hold S positions, as the wrapper sizes
// its scratch.
int splits(int S) { return S > kSplit ? (S + kSplit - 1) / kSplit : 1; }

template <typename T, typename TO, typename Kernel>
int launch_split(Kernel kernel, size_t smem, const SplitArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.nsplit, a.KV, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), a.k, a.v,
      static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale), a.kv_len, a.block_tables,
      static_cast<TO*>(a.out), a.lse, a.part, a.tickets, a.KV, a.G, a.S,
      a.page, a.nblk, a.nsplit, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kPaged, bool kQ8, bool kLse>
int run_split(const SplitArgs& a, bool bf16) {
  if (bf16) {
    constexpr size_t smem = sizeof(__nv_bfloat16) *
        ((2 * kSplit + kGroup) * (D + 8) + 2 * kGroup * (kSplit + 8)) +
        sizeof(float) * 2 * kWarps * kGroup;
    return launch_split<__nv_bfloat16,
                        std::conditional_t<kLse, float, __nv_bfloat16>>(
        flash_decode_mma_kernel<D, kPaged, kQ8, kLse>, smem, a);
  }
  constexpr size_t smem = sizeof(float) *
      (2 * kSplit * (D + 4) + kGroup * D + kGroup * (kSplit + 4) +
       2 * kGroup);
  return launch_split<float, float>(
      flash_decode_f32_kernel<D, kPaged, kQ8, kLse>, smem, a);
}

// D = 80 (zamba2's shared block) and D = 256 (paligemma-3b) have
// contiguous instances only: no path pages such a cache (the paged engine
// refuses the hybrid and vision families). kLse: contiguous caches, and
// only the head dims that serve sequence-sharded (64: granite-moe; 80:
// zamba2's shared block at batch 1; 128: the dense GQA models; 256:
// paligemma-3b's one KV head).
template <bool kPaged, bool kQ8, bool kLse = false>
int split_by_dim(const SplitArgs& a, int D, bool bf16) {
  static_assert(!(kLse && kPaged), "the log-sum-exp instance is contiguous");
  if constexpr (kLse) {
    switch (D) {
      case 64: return run_split<64, false, false, true>(a, bf16);
      case 80: return run_split<80, false, false, true>(a, bf16);
      case 128: return run_split<128, false, false, true>(a, bf16);
      case 256: return run_split<256, false, false, true>(a, bf16);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (D) {
      case 16: return run_split<16, kPaged, kQ8, false>(a, bf16);
      case 32: return run_split<32, kPaged, kQ8, false>(a, bf16);
      case 64: return run_split<64, kPaged, kQ8, false>(a, bf16);
      case 80:
        if constexpr (!kPaged)
          return run_split<80, kPaged, kQ8, false>(a, bf16);
        return static_cast<int>(cudaErrorInvalidValue);
      case 128: return run_split<128, kPaged, kQ8, false>(a, bf16);
      case 256:
        if constexpr (!kPaged)
          return run_split<256, kPaged, kQ8, false>(a, bf16);
        return static_cast<int>(cudaErrorInvalidValue);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace

// Contiguous caches. q (B, KV, G, D) and k, v (B, S, KV, D), 16-byte
// aligned; kv_len (B,) int32; out (B, KV, G, D); q, k, v and out share one
// dtype, f32 or bf16 (is_bf16). D in {16, 32, 64, 80, 128, 256}, any
// G >= 1.
// nsplit = ceil(S / 64), the splits the caller sized part for: f32 scratch
// of B * KV * nsplit * G * (D + 2) floats (unused, and may be null, when
// nsplit is 1); tickets: B * KV int32 zeros, left zero. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, int is_bf16,
                                   const int* kv_len, void* out, void* part,
                                   void* tickets, int B, int KV, int G, int D,
                                   int S, int nsplit, float scale,
                                   void* stream) {
  if (G < 1 || S < 0 || nsplit != splits(S))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, nullptr, nullptr, kv_len, nullptr, out, nullptr,
                    static_cast<float*>(part), static_cast<int*>(tickets), B,
                    KV, G, S, 0, 0, nsplit, scale,
                    static_cast<cudaStream_t>(stream)};
  return split_by_dim<false, false>(a, D, is_bf16 != 0);
}

// The log-sum-exp instance, contiguous caches: as flash_decode_launch, but
// D in {64, 128}, out (B, KV, G, D) is f32 whatever q's dtype, and lse
// (B, KV, G) f32 receives m + log(l) (-inf, beside a zero output, where
// kv_len is 0).
extern "C" int flash_decode_lse_launch(const void* q, const void* k,
                                       const void* v, int is_bf16,
                                       const int* kv_len, void* out,
                                       void* lse, void* part, void* tickets,
                                       int B, int KV, int G, int D, int S,
                                       int nsplit, float scale,
                                       void* stream) {
  if (G < 1 || S < 0 || nsplit != splits(S) || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, nullptr, nullptr, kv_len, nullptr, out,
                    static_cast<float*>(lse), static_cast<float*>(part),
                    static_cast<int*>(tickets), B, KV, G, S, 0, 0, nsplit,
                    scale, static_cast<cudaStream_t>(stream)};
  return split_by_dim<false, false, true>(a, D, is_bf16 != 0);
}

// Page pools. q (B, KV, G, D) and k, v (P, page, KV, D), 16-byte aligned;
// block_tables (B, nblk) int32, each entry a page of the pools; kv_len (B,)
// int32, at most nblk * page counted; out (B, KV, G, D); q, k, v and out
// share one dtype, f32 or bf16 (is_bf16). D in {16, 32, 64, 128}, any
// G >= 1, any page >= 1. nsplit = ceil(nblk * page / 64), part and
// tickets as for flash_decode_launch. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_decode_paged_launch(const void* q, const void* k,
                                         const void* v, int is_bf16,
                                         const int* kv_len,
                                         const int* block_tables, void* out,
                                         void* part, void* tickets, int B,
                                         int KV, int G, int D, int page,
                                         int nblk, int nsplit, float scale,
                                         void* stream) {
  const long long S = static_cast<long long>(page) * nblk;
  if (G < 1 || page < 1 || nblk < 0 || S > (1 << 30) ||
      block_tables == nullptr || nsplit != splits(static_cast<int>(S)))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, nullptr, nullptr, kv_len, block_tables, out,
                    nullptr, static_cast<float*>(part),
                    static_cast<int*>(tickets), B,
                    KV, G, static_cast<int>(S), page, nblk, nsplit, scale,
                    static_cast<cudaStream_t>(stream)};
  return split_by_dim<true, false>(a, D, is_bf16 != 0);
}

// int8 page pools: codes k, v (P, page, KV, D) int8, 16-byte aligned;
// scales k_scale, v_scale (P, page, KV, 1) bf16; q and out (B, KV, G, D) in
// one dtype, f32 or bf16 (is_bf16); the rest as for
// flash_decode_paged_launch. Each entry is attended as bf16(code * scale).
extern "C" int flash_decode_paged_q8_launch(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, int is_bf16, const int* kv_len,
    const int* block_tables, void* out, void* part, void* tickets, int B,
    int KV, int G, int D, int page, int nblk, int nsplit, float scale,
    void* stream) {
  const long long S = static_cast<long long>(page) * nblk;
  if (G < 1 || page < 1 || nblk < 0 || S > (1 << 30) ||
      block_tables == nullptr || k_scale == nullptr || v_scale == nullptr ||
      nsplit != splits(static_cast<int>(S)))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, k_scale, v_scale, kv_len, block_tables, out,
                    nullptr, static_cast<float*>(part),
                    static_cast<int*>(tickets), B,
                    KV, G, static_cast<int>(S), page, nblk, nsplit, scale,
                    static_cast<cudaStream_t>(stream)};
  return split_by_dim<true, true>(a, D, is_bf16 != 0);
}
