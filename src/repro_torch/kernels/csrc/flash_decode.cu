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
// scales (P, page, KV, 1). A CTA stages its rows' codes and scales through
// the same cp.async ring as bf16 rows, and dequantizes each entry once into
// shared memory as the reference's dequantize_kv does: the f32 product
// code * scale rounded to bf16 (bf16 rows for the tensor-core kernel; the
// same bf16 values as f32 for the f32 kernel, which attends f32 q against
// them). Everything after that is the bf16 or f32 kernel unchanged. The
// rows cost D + 2 bytes a head where bf16 pools cost 2 D.
//
// Layout: q (B, KV, G, D) and out (B, KV, G, D), the reference's.
//
// What bounds it on the H100: bytes. A decode step reads each K/V row once
// per KV head and does 4 * G * D flops on its 4 * D bytes (bf16), G flops a
// byte (9 for starcoder2-7b), far below the card's ratio even at f32's 67
// TFLOP/s. So the design has to keep enough rows in flight on all 132 SMs,
// whatever the cache's length, and keep the work that is not a load (the
// merge above all) short.
//
// The plan (decode_plan in kernels/flash_decode.py): one CTA of 128
// threads per (split, KV head and group of kGroup = 16 query heads,
// request), nsplit splits a request, chosen on the host from the shapes
// (B, KV, G, the cache's width S or a pool's nblk * page) and the SM count:
// two CTAs an SM for caches of at most 1,536 positions (the lanes' mixed
// lengths), one for longer ones (where a split's share of the merge costs
// more than a second CTA an SM gains), no more than fit an SM's shared
// memory (one at D = 256), at least 4 splits and at most one a 64-row tile;
// f32 q on a short cache aims at 8 CTAs an SM, more and shorter splits
// than fit at once (its FMA work, not the merge, bounds an f32 tile).
// The host never reads kv_len or the block tables, so one grid serves
// every length (a CUDA graph can hold the step). Each CTA finds its rows on
// the device: request b's nt = ceil(kv_len[b] / 64) tiles are dealt out
// evenly in whole tiles over its nwork = min(nt, nsplit) working splits,
// split s taking tiles s * nt / nwork .. (s + 1) * nt / nwork; splits past
// nwork exit before any load. So a (1, 2) request of 32,768 rows is
// 2 x 66 CTAs of ~8 tiles, not 1,024 of one, and a paged engine's wide
// table (320 entries of 16 rows) launches a few splits a request, not 80.
//
// Inside a CTA, a loop over its tiles with a ring of kS stages in shared
// memory (stages(): three or four of bf16 rows, one to three of f32 rows):
// 16-byte cp.async copies of the
// next tiles' K and V rows, in their storage type, are in flight while the
// current one is scored. A paged CTA looks up the pool row of each of its
// positions in the request's block-table row two tiles ahead
// (bt[t / page] * page + t % page, walked without a division a row), so
// any page size works, a tile may span pages unevenly, and no copy waits
// on a lookup; a contiguous CTA reads rows b * S + t. The softmax is online
// across the tiles: the running max m, sum l and acc are rescaled by
// exp(m_old - m_new) as each tile raises the max. bf16
// (flash_decode_mma_kernel): the CTA's q rows are the A operand of
// mma.sync m16n8k16, so each warp scores 16 keys for all 16 heads at once
// (exact bf16 products summed in f32), the tile's max and sum cross the
// warps through shared memory, scores go to units of log2 for exp2, and
// p . V runs on the tensor cores with p split into bf16 hi + lo as in
// flash_prefill (p to ~16 mantissa bits); m, l and acc stay in registers.
// f32 (flash_decode_f32_kernel, the f32 consistency runs): plain FMA, each
// thread dotting a cache row with up to 8 heads' q rows and accumulating
// p . V for one column pair of its heads, m and l in shared memory.
//
// The merge (merge_if_last, merge_blocks): each working split writes f32
// partials (acc[ng][D], m[ng], l[ng]) to scratch from the wrapper; the
// last CTA of each (request, KV head, group) to finish, found by an atomic
// ticket, merges them and resets the ticket for the next launch: one
// launch a call. All 128 threads merge, with up to 16 loads from L2 in
// flight each: each head's max and sum over the splits (a warp per four
// heads, shuffles), then the weighted sum of the partials in float4
// chunks. Where one pass would take more than 8 rounds of loads (many
// splits of many heads), the splits go in chunks of 8 whose last CTA
// merges its chunk while others still work, and the last chunk merger
// merges the chunks. A request whose kv_len fits one split writes its
// output directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tile_ops.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;       // positions per tile
constexpr int kGroup = 16;       // query heads a CTA
constexpr int kChunk = 8;        // splits the merge's first level takes
constexpr float kLn2 = 0.69314718055994531f;
static_assert(2 * kSplit == kThreads, "a thread per (row, head parity)");
// The split-K kernels' launch bounds name a minimum of one CTA an SM:
// without it ptxas spills registers at some D to raise occupancy.

// The ring's stages for rows of D entries of T (kQ8: int8 codes and their
// scale words, 17 KB a stage at D = 128, beside one dequantized tile).
// bf16: as many as leave room for two CTAs an SM (three at D = 128:
// 114 KB a CTA; at D = 256 one CTA fits, with three stages, 216 KB), four
// of int8. f32 (the consistency runs, whose tiles the FMA work bounds, in
// short splits on short caches): two CTAs an SM before a deep ring, so
// three stages up to D = 64, two at 80, one past it, and two of int8.
template <int D, bool kQ8, typename T>
__host__ __device__ constexpr int stages() {
  if (sizeof(T) == 2) return kQ8 || D <= 80 ? 4 : 3;
  if (kQ8) return 2;
  if (D <= 64) return 3;
  return D > 80 ? 1 : 2;
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Floats of one split's block of partials for a CTA's ng <= kGroup heads:
// acc[ng][D], m[ng], l[ng], in blocks sized for min(G, kGroup) heads and
// padded so that every block starts 16-byte aligned (flash_decode.py's
// part_stride).
__host__ __device__ inline int part_stride(int G, int D) {
  return round4((G < kGroup ? G : kGroup) * (D + 2));
}

// The merge's int32 tickets a CTA row (request, KV head, group of heads):
// one a chunk of kChunk splits and one for the row (flash_decode.py's
// ticket_stride).
__device__ __forceinline__ int ticket_stride(int nsplit) {
  return (nsplit + kChunk - 1) / kChunk + 1;
}

// Floats of shared memory a merge takes: each head's max and sum, and 128
// float4 sums of chunks.
constexpr int kMergeFloats = 2 * kGroup + 4 * kThreads;

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

template <bool kLog2>
__device__ __forceinline__ float ex(float x) {
  return kLog2 ? exp2f(x) : expf(x);
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

// Position t's page p = t / page and row o = t % page, walked forward by
// steps of d rows: the divisions once a tile, none a row.
struct PageWalk {
  int p, o, dp, dr;
  __device__ __forceinline__ PageWalk(int t, int page, int d)
      : p(t / page), o(t % page), dp(d / page), dr(d % page) {}
  __device__ __forceinline__ void step(int page) {
    p += dp;
    o += dr;
    if (o >= page) {
      o -= page;
      ++p;
    }
  }
};

// 4 bytes from src to the shared address dst (zeros with full false)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0));
}

// int8 pools: a tile's codes and scales go through the cp.async ring as
// bf16 rows do, and are dequantized into the kernel's K and V rows when
// the tile is scored. A stage holds the K and V codes ([kSplit][D] bytes
// each), then the 4-byte words that hold each row's K and V scales (a
// bf16 scale is 2-byte aligned, and cp.async copies 4 bytes at least),
// then which half of its word each row's scale is. Thread tid takes
// 16-byte chunk tid % (D / 16) of rows tid / (D / 16) + i * kStep; the
// thread of a row's first chunk copies its scale words. A pool's last
// scale, when it starts a word that runs past the pool (nscale odd), is
// read by a plain load instead.
template <int D>
struct Q8 {
  static constexpr int kC = D / 16;         // 16-byte chunks of codes a row
  static constexpr int kStep = kThreads / kC;
  static constexpr int kPer = (kSplit + kStep - 1) / kStep;
  static constexpr int kBytes = 2 * kSplit * D + 2 * kSplit * 4 + 2 * kSplit;

  // rows r < n of the tile into stage st; row_of(i, r): row r's row of
  // the pools' (P * page * KV) rows (this thread's i-th)
  template <typename RowOf>
  static __device__ __forceinline__ void issue(
      unsigned char* st, const signed char* kc, const __nv_bfloat16* ksc,
      const signed char* vc, const __nv_bfloat16* vsc, long long nscale,
      int n, RowOf row_of) {
    const int cr = threadIdx.x / kC;
    const int ce = threadIdx.x % kC * 16;
    uint32_t* sw = reinterpret_cast<uint32_t*>(st + 2 * kSplit * D);
    unsigned char* half = st + 2 * kSplit * D + 2 * kSplit * 4;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = cr + i * kStep;
      if (r >= kSplit) break;
      const bool ok = r < n;                // rows past the length read 0
      const long long row = ok ? row_of(i, r) : 0;
      cp_async16(smem_addr(st + r * D + ce), kc + row * D + ce, ok);
      cp_async16(smem_addr(st + (kSplit + r) * D + ce), vc + row * D + ce,
                 ok);
      if (ce == 0) {
        const long long w = row & ~1LL;     // the word's first scale
        half[r] = static_cast<unsigned char>(row & 1);
        if (w + 1 < nscale || !ok) {
          cp_async4(smem_addr(sw + r), ksc + w, ok);
          cp_async4(smem_addr(sw + kSplit + r), vsc + w, ok);
        } else {
          sw[r] = __ldg(reinterpret_cast<const unsigned short*>(ksc + w));
          sw[kSplit + r] =
              __ldg(reinterpret_cast<const unsigned short*>(vsc + w));
        }
      }
    }
  }

  // stage st dequantized into the rows ks and vs (row stride LD entries of
  // T): each entry the f32 product code * scale rounded to bf16, as the
  // reference's dequantize_kv gives it
  template <typename T>
  static __device__ __forceinline__ void dequant(const unsigned char* st,
                                                 T* ks, T* vs, int LD) {
    const int cr = threadIdx.x / kC;
    const int ce = threadIdx.x % kC * 16;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(st + 2 * kSplit * D);
    const unsigned char* half = st + 2 * kSplit * D + 2 * kSplit * 4;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = cr + i * kStep;
      if (r >= kSplit) break;
      const int sh = half[r] * 16;
      store_dequant(ks + r * LD + ce,
                    *reinterpret_cast<const int4*>(st + r * D + ce),
                    __uint_as_float((sw[r] >> sh) << 16));
      store_dequant(vs + r * LD + ce,
                    *reinterpret_cast<const int4*>(st + (kSplit + r) * D + ce),
                    __uint_as_float((sw[kSplit + r] >> sh) << 16));
    }
  }
};

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// four outputs a / max(l, 1e-30)
__device__ __forceinline__ void store4(float* p, float4 a, float l) {
  const float d = fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(p) =
      make_float4(__fdividef(a.x, d), __fdividef(a.y, d), __fdividef(a.z, d),
                  __fdividef(a.w, d));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a, float l) {
  const float d = fmaxf(l, 1e-30f);
  const __nv_bfloat162 x =
      __floats2bfloat162_rn(__fdividef(a.x, d), __fdividef(a.y, d));
  const __nv_bfloat162 y =
      __floats2bfloat162_rn(__fdividef(a.z, d), __fdividef(a.w, d));
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&x),
                 *reinterpret_cast<const uint32_t*>(&y));
}

// The merge of the splits' partials. Split s of the CTA's ng heads of
// request b, KV head h writes, in part's block of part_stride(G, D)
// floats, acc[ng][D] (unnormalized p . V), then m[ng] and l[ng], m in the
// units the kernel's exponential takes (kLog2: scores times log2(e), for
// exp2f; else expf's). merge_blocks combines the n blocks s0, s0 + step,
// ... with the CTA's shared memory sm (kMergeFloats floats, free by then):
// into the outputs o as acc / l (final), or back into block s0 as one
// partial (acc and l relative to the blocks' max m). It is a chain of
// loads from L2, so each thread keeps up to 16 in flight:
// 1. warp w takes heads w, w + 4, w + 8, w + 12, all at once: lane j the
//    blocks j, j + 32, ... of each, its max and sum online, then the
//    warp's max M and sum L of each head by shuffles (kLse, final: lo[g] =
//    M + log(L), in natural-log units);
// 2. the blocks' acc weighted by exp(m_s - M) and summed, over float4
//    chunks of the ng x D outputs: thread t takes chunks t, t + 128, ...
//    (kU at most), all of them for kB blocks at a time; with fewer than 64
//    chunks, R2 = 128 / chunks threads share a chunk's blocks and their
//    sums meet in shared memory.
template <int D, bool kLog2, bool kLse, typename T>
__device__ __forceinline__ void merge_blocks(const float* pbh, int stride,
                                             int ng, int s0, int step, int n,
                                             bool final, T* o, float* lo,
                                             float* sm) {
  constexpr int kC4 = D / 4;                // float4 chunks a head's row
  constexpr int kH = kGroup / kWarps;       // heads a warp
  constexpr int kU = (kGroup * kC4 + kThreads - 1) / kThreads;
  constexpr int kB = 16 / kU > 0 ? 16 / kU : 1;  // blocks a batch
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ms = sm;                           // [ng] max
  float* ls = ms + kGroup;                  // [ng] sum
  float4* red = reinterpret_cast<float4*>(ls + kGroup);
  auto block = [&](int i) {                 // block i of the n
    return pbh + static_cast<long long>(s0 + i * step) * stride;
  };
  float* back = const_cast<float*>(block(0));
  {
    float m[kH], l[kH];
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    for (int s = lane; s < n; s += 32) {
      const float* ml = block(s) + ng * D;
      float mv[kH], lv[kH];
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        const int g = warp + kWarps * i;
        mv[i] = g < ng ? __ldcg(ml + g) : -INFINITY;
        lv[i] = g < ng ? __ldcg(ml + ng + g) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        const float mn = fmaxf(m[i], mv[i]);
        if (mn > -INFINITY) {               // no block yet: nothing to add
          l[i] = l[i] * ex<kLog2>(m[i] - mn) + lv[i] * ex<kLog2>(mv[i] - mn);
          m[i] = mn;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      const int g = warp + kWarps * i;
      const float mt = warp_max(m[i]);      // finite for g < ng
      const float lt =
          warp_sum(m[i] > -INFINITY ? l[i] * ex<kLog2>(m[i] - mt) : 0.f);
      if (lane == 0 && g < ng) {
        ms[g] = mt;
        ls[g] = lt;
        if constexpr (kLse)
          if (final) lo[g] = (kLog2 ? mt * kLn2 : mt) + logf(lt);
      }
    }
  }
  __syncthreads();
  auto put = [&](int u, float4 a) {         // chunk u is entries 4u ..
    if (final)
      store4(o + 4 * u, a, ls[u / kC4]);
    else
      reinterpret_cast<float4*>(back)[u] = a;
  };
  const int U = ng * kC4;
  if (U >= kThreads / 2) {
    float4 a[kU];
    float m[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const int u = tid + j * kThreads;
      m[j] = u < U ? ms[u / kC4] : 0.f;
      a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s = 0; s < n; s += kB) {
      float mv[kU][kB];
      float4 x[kU][kB];
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const float* blk = block(min(s + i, n - 1));
#pragma unroll
        for (int j = 0; j < kU; ++j) {
          const int u = tid + j * kThreads;
          const bool in = s + i < n && u < U;
          mv[j][i] = in ? __ldcg(blk + ng * D + u / kC4) : -INFINITY;
          x[j][i] = in ? __ldcg(reinterpret_cast<const float4*>(blk) + u)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) {
#pragma unroll
        for (int j = 0; j < kU; ++j) {
          const float w = ex<kLog2>(mv[j][i] - m[j]);  // 0 past n
          a[j].x = fmaf(w, x[j][i].x, a[j].x);
          a[j].y = fmaf(w, x[j][i].y, a[j].y);
          a[j].z = fmaf(w, x[j][i].z, a[j].z);
          a[j].w = fmaf(w, x[j][i].w, a[j].w);
        }
      }
    }
    if (!final) __syncthreads();            // every read of block 0 is done
#pragma unroll
    for (int j = 0; j < kU; ++j)
      if (tid + j * kThreads < U) put(tid + j * kThreads, a[j]);
  } else {
    const int R2 = kThreads / U;
    if (tid < R2 * U) {
      const int u = tid % U;
      const float m = ms[u / kC4];
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = tid / U; s < n; s += 16 * R2) {
        float mv[16];
        float4 x[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int si = s + i * R2;
          const float* blk = block(min(si, n - 1));
          mv[i] = si < n ? __ldcg(blk + ng * D + u / kC4) : -INFINITY;
          x[i] = si < n ? __ldcg(reinterpret_cast<const float4*>(blk) + u)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float w = ex<kLog2>(mv[i] - m);
          a.x = fmaf(w, x[i].x, a.x);
          a.y = fmaf(w, x[i].y, a.y);
          a.z = fmaf(w, x[i].z, a.z);
          a.w = fmaf(w, x[i].w, a.w);
        }
      }
      red[tid] = a;
    }
    __syncthreads();
    if (tid < U) {
      float4 a = red[tid];
      for (int r = 1; r < R2; ++r) {
        const float4 x = red[r * U + tid];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      put(tid, a);
    }
  }
  if (!final) {                             // block 0's m and l, once every
    __syncthreads();                        // weight is read
    if (tid < ng) {
      back[ng * D + tid] = ms[tid];
      back[ng * D + ng + tid] = ls[tid];
    }
  }
}

// true in one CTA: the last of the ``of`` to take *ticket, which it resets
// to 0 for the next launch; the writes of all of them are visible to it
__device__ __forceinline__ bool last_of(int* ticket, int of) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == of - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// After split s has written its block. A merge that takes a few rounds of
// loads (nwork at most 8 batches of merge_blocks' pass 2) is flat: the
// last split to finish (the row's ticket) merges them all. Else two
// levels: the splits go in chunks of kChunk, the last of each chunk to
// finish (its chunk's ticket) merges the chunk into the chunk's first
// block, overlapping the splits still at work, and the last chunk merger
// (the row's ticket) merges the chunks into the output. tickets: the CTA
// row's ceil(nsplit / kChunk) chunk tickets, then its own.
template <int D, bool kLog2, bool kLse, typename T>
__device__ __forceinline__ void merge_if_last(const float* pbh, int stride,
                                              int* tickets, T* o, float* lo,
                                              int ng, int nwork, int nsplit,
                                              float* sm) {
  constexpr int kC4 = D / 4;
  constexpr int kU = (kGroup * kC4 + kThreads - 1) / kThreads;
  const int U = ng * kC4;                   // merge_blocks' blocks a batch
  const int batch = U >= kThreads / 2 ? (16 / kU > 0 ? 16 / kU : 1)
                                      : 16 * (kThreads / U);
  int* row = tickets + (nsplit + kChunk - 1) / kChunk;
  if (nwork <= 8 * batch) {
    if (last_of(row, nwork))
      merge_blocks<D, kLog2, kLse>(pbh, stride, ng, 0, 1, nwork, true, o, lo,
                                   sm);
    return;
  }
  const int c = blockIdx.x / kChunk;
  const int nchunks = (nwork + kChunk - 1) / kChunk;
  const int c0 = c * kChunk;
  if (!last_of(tickets + c, min(kChunk, nwork - c0))) return;
  if (nchunks == 1) {
    merge_blocks<D, kLog2, kLse>(pbh, stride, ng, 0, 1, nwork, true, o, lo,
                                 sm);
    return;
  }
  merge_blocks<D, kLog2, kLse>(pbh, stride, ng, c0, 1,
                               min(kChunk, nwork - c0), false, o, lo, sm);
  if (!last_of(row, nchunks)) return;
  merge_blocks<D, kLog2, kLse>(pbh, stride, ng, 0, kChunk, nchunks, true, o,
                               lo, sm);
}

// The rows a CTA owns: request b's nt = ceil(len / kSplit) tiles dealt
// evenly over its nwork = min(nt, nsplit) working splits, split s taking
// tiles ta .. ta + ntile (flash_decode.py's split_rows). Splits at or past
// nwork own nothing. The CTA serves heads g0 .. g0 + ng of KV head h
// (grid y = h * ngroups + the group of kGroup heads).
struct Work {
  int len, nwork, ta, ntile, h, g0, ng;
  long long bh;
  __device__ __forceinline__ Work(const int* kv_len, int S, int nsplit,
                                  int KV, int G) {
    const int ngroups = (G + kGroup - 1) / kGroup;
    h = blockIdx.y / ngroups;
    g0 = blockIdx.y % ngroups * kGroup;
    ng = min(kGroup, G - g0);
    bh = static_cast<long long>(blockIdx.z) * KV + h;
    len = max(0, min(kv_len[blockIdx.z], S));
    const int nt = (len + kSplit - 1) / kSplit;
    const int split = blockIdx.x;
    nwork = min(nt, nsplit);
    ta = nwork ? static_cast<int>(static_cast<long long>(split) * nt / nwork)
               : 0;
    ntile = nwork ? static_cast<int>(static_cast<long long>(split + 1) * nt /
                                     nwork) - ta
                  : 0;
  }
  __device__ __forceinline__ int t0(int i) const {  // tile i's first row
    return (ta + i) * kSplit;
  }
  __device__ __forceinline__ int rows(int i) const {
    return min(kSplit, len - t0(i));
  }
  // this (request, KV head, group)'s ticket and its splits' partials
  __device__ __forceinline__ long long cta() const {
    return static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  }
};

// bf16 caches: the tensor cores. The CTA's ng heads are the rows of the
// mma's A (past ng zero); per tile, warp w scores keys 16 w .. 16 w + 15
// against all of them (S = q . K^T, mma.sync, exact products summed in
// f32); the tile's row max and sum cross the warps through shared memory;
// p, split into bf16 hi + lo, goes to shared memory as the A operand of
// P . V, of which warp w computes column tiles w * kNTW .. (V by
// ldmatrix.trans) into acc, rescaled first by exp2(m_old - m_new). S is
// the positions a request can hold: the cache's rows, or a pool's
// nblk * page.
//
// kQ8: the pools are int8 codes with bf16 scales (k_scale, v_scale): the
// ring stages them (Q8) and each tile is dequantized into one bf16 tile
// before it is scored. kLse: the output is f32 and lse (B, KV, G) f32 is
// written beside it.
template <int D, bool kPaged, bool kQ8, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const void* __restrict__ k,
                        const void* __restrict__ v,
                        const __nv_bfloat16* __restrict__ k_scale,
                        const __nv_bfloat16* __restrict__ v_scale,
                        long long nscale,
                        const int* __restrict__ kv_len,
                        const int* __restrict__ block_tables,
                        std::conditional_t<kLse, float, __nv_bfloat16>*
                            __restrict__ out,
                        float* __restrict__ lse,
                        float* __restrict__ part, int* __restrict__ tickets,
                        int KV, int G, int S, int page, int nblk, int nsplit,
                        float scale) {
  constexpr int LD = D + 8;                 // a K/V/q row, padded 16 bytes
  // the rows a thread copies: 16-byte chunks, D / 8 a bf16 row (D / 16 of
  // int8 codes); with D = 80 (12 rows a pass over 120 threads) the threads
  // past kRowStep * kChunks copy nothing, so that each row has one owner
  constexpr int kChunks = kQ8 ? D / 16 : D / 8;
  constexpr int kRowStep = kThreads / kChunks;
  constexpr bool kAllCopy = kRowStep * kChunks == kThreads;
  constexpr int kRows = (kSplit + kRowStep - 1) / kRowStep;
  constexpr int kPLD = kSplit + 8;          // a row of p, padded 16 bytes
  constexpr int kNT = D / 8;                // output column tiles
  constexpr int kNTW = (kNT + kWarps - 1) / kWarps;
  constexpr int kS = stages<D, kQ8, __nv_bfloat16>();
  constexpr int kTile = 2 * kSplit * LD;    // K rows, then V rows
  // a stage: a bf16 tile, or an int8 one (Q8)
  constexpr int kStage = kQ8 ? Q8<D>::kBytes
                             : kTile * static_cast<int>(sizeof(__nv_bfloat16));
  static_assert(kS >= 2, "the bf16 ring has two stages at least");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  __nv_bfloat16* qtile = reinterpret_cast<__nv_bfloat16*>(ring + kS * kStage);
  __nv_bfloat16* qs = qtile + (kQ8 ? kTile : 0);  // int8: the dequantized
  __nv_bfloat16* phi = qs + kGroup * LD;    // tile, then q (kGroup x LD)
  __nv_bfloat16* plo = phi + kGroup * kPLD;  // and p (kGroup x kPLD)
  float* rmax = reinterpret_cast<float*>(plo + kGroup * kPLD);  // [w][row]
  float* rsum = rmax + kWarps * kGroup;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int qd = lane & 3;
  const Work wk(kv_len, S, nsplit, KV, G);
  const int b = blockIdx.z;
  const int h = wk.h;
  const int ng = wk.ng;
  auto* o = out + (wk.bh * G + wk.g0) * D;
  float* lo = kLse ? lse + wk.bh * G + wk.g0 : nullptr;
  if (blockIdx.x >= max(wk.nwork, 1)) return;
  if (wk.nwork == 0) {                      // kv_len 0: zeros (lse -inf)
    for (int i = tid; i < ng * D; i += kThreads) store(o + i, 0.f);
    if constexpr (kLse)
      for (int i = tid; i < ng; i += kThreads) lo[i] = -INFINITY;
    return;
  }
  const int steps = wk.ntile;
  const int cr = tid / kChunks;             // this thread's copies: rows
  const int cc = tid % kChunks;             // cr + i kRowStep, chunk cc
  const bool copier = kAllCopy || cr < kRowStep;
  const int* bt = kPaged ? block_tables + static_cast<long long>(b) * nblk
                         : nullptr;
  // paged: the pool page and row of this thread's rows of the even and of
  // the odd tiles, loaded two issues ahead, so that no issue waits on a
  // block-table lookup
  int pid0[kRows], off0[kRows], pid1[kRows], off1[kRows];
  auto pages = [&](int j) {
    if (!kPaged || j >= steps || !copier) return;
    auto fill = [&](int (&pid)[kRows], int (&off)[kRows]) {
      PageWalk pw(wk.t0(j) + cr, page, kRowStep);
      const int n = wk.rows(j);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pid[i] = cr + i * kRowStep < n ? __ldg(bt + pw.p) : 0;
        off[i] = pw.o;
        pw.step(page);
      }
    };
    if (j & 1)
      fill(pid1, off1);
    else
      fill(pid0, off0);
  };
  auto stage = [&](int j) { return ring + j % kS * kStage; };
  auto issue_rows = [&](int j, const int (&pid)[kRows],
                        const int (&off)[kRows]) {
    const int t0 = wk.t0(j);
    const int n = wk.rows(j);
    auto row_of = [&](int i, int r) {       // position t0 + r's pool row
      return (kPaged ? static_cast<long long>(pid[i]) * page + off[i]
                     : static_cast<long long>(b) * S + t0 + r) * KV + h;
    };
    if constexpr (kQ8) {
      Q8<D>::issue(stage(j), static_cast<const signed char*>(k), k_scale,
                   static_cast<const signed char*>(v), v_scale, nscale, n,
                   row_of);
    } else {
      const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
      const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
      __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(stage(j));
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = cr + i * kRowStep;
        if (r >= kSplit) break;
        const bool ok = r < n;              // rows past the length read 0
        const long long at = ok ? row_of(i, r) * D + cc * 8 : 0;
        cp_async16(smem_addr(ks + r * LD + cc * 8), kb + at, ok);
        cp_async16(smem_addr(ks + (kSplit + r) * LD + cc * 8), vb + at, ok);
      }
    }
  };
  auto issue = [&](int j) {                 // tile j's rows into its stage
    if (j >= steps || !copier) return;
    if (j & 1)
      issue_rows(j, pid1, off1);
    else
      issue_rows(j, pid0, off0);
    pages(j + 2);
  };
  for (int c = tid; c < kGroup * D / 8; c += kThreads) {
    const int r = c / (D / 8);              // q rows past ng read as 0
    const int e = c % (D / 8) * 8;
    cp_async16(smem_addr(qs + r * LD + e),
               q + (r < ng ? (wk.bh * G + wk.g0 + r) * D + e : 0), r < ng);
  }
  pages(0);
  pages(1);
#pragma unroll
  for (int j = 0; j < kS - 1; ++j) {        // q rides with tile 0
    issue(j);
    cp_async_commit();
  }
  const float sl2 = scale * 1.44269504088896341f;
  const bool direct = wk.nwork == 1;
  const int stride = part_stride(G, D);
  float* pbh = part + wk.cta() * nsplit * stride;
  float* pb = pbh + blockIdx.x * stride;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows grp, grp + 8
  float l_run[2] = {0.f, 0.f};
  float acc[kNTW][4] = {};

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kS - 2>();                // tile it's rows have landed
    __syncthreads();                        // ... and tile it - 1 is done
    issue(it + kS - 1);
    cp_async_commit();
    const __nv_bfloat16* ks = kQ8 ? qtile
        : reinterpret_cast<const __nv_bfloat16*>(stage(it));
    if constexpr (kQ8) {
      Q8<D>::dequant(stage(it), qtile, qtile + kSplit * LD, LD);
      __syncthreads();
    }
    const __nv_bfloat16* vs = ks + kSplit * LD;
    const int n = wk.rows(it);
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
    // scores in units of log2; a tile's key 0 is valid, so every row's
    // max is finite
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
    float m0 = m_run[0], m1 = m_run[1];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      m0 = fmaxf(m0, rmax[w * kGroup + grp]);
      m1 = fmaxf(m1, rmax[w * kGroup + grp + 8]);
    }
    const float al0 = exp2f(m_run[0] - m0);  // 0 on the first tile
    const float al1 = exp2f(m_run[1] - m1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
      const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      const int col = warp * 16 + j * 8 + qd * 2;
      uint32_t hi, lo2;
      split_bf16(p0, p1, hi, lo2);
      *reinterpret_cast<uint32_t*>(phi + grp * kPLD + col) = hi;
      *reinterpret_cast<uint32_t*>(plo + grp * kPLD + col) = lo2;
      split_bf16(p2, p3, hi, lo2);
      *reinterpret_cast<uint32_t*>(phi + (grp + 8) * kPLD + col) = hi;
      *reinterpret_cast<uint32_t*>(plo + (grp + 8) * kPLD + col) = lo2;
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    if (qd == 0) {
      rsum[warp * kGroup + grp] = sum0;
      rsum[warp * kGroup + grp + 8] = sum1;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al0;
      acc[i][2] *= al1;
      acc[i][3] *= al1;
    }
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
    float lt0 = 0.f, lt1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lt0 += rsum[w * kGroup + grp];
      lt1 += rsum[w * kGroup + grp + 8];
    }
    l_run[0] = fmaf(l_run[0], al0, lt0);
    l_run[1] = fmaf(l_run[1], al1, lt1);
    m_run[0] = m0;
    m_run[1] = m1;
  }
  // the output (one working split) or the split's partials
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
        const float d = fmaxf(l_run[half], 1e-30f);
        store_pair(o + g * D + col, __fdividef(x, d), __fdividef(y, d));
      } else {
        *reinterpret_cast<float2*>(pb + g * D + col) = make_float2(x, y);
      }
    }
  }
  if ((!direct || kLse) && warp == 0 && qd == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int g = grp + 8 * half;
      if (g >= ng) continue;
      if (!direct) {
        pb[ng * D + g] = m_run[half];
        pb[ng * D + ng + g] = l_run[half];
      } else if constexpr (kLse) {          // m in units of log2
        lo[g] = m_run[half] * kLn2 + logf(l_run[half]);
      }
    }
  }
  if (!direct)
    merge_if_last<D, true, kLse>(
        pbh, stride, tickets + wk.cta() * ticket_stride(nsplit), o, lo, ng,
        wk.nwork, nsplit, reinterpret_cast<float*>(smem_raw));
}

// f32 caches: plain f32 FMA, which the 1e-5 check of the f32 consistency
// runs needs. The CTA's ng heads' q rows sit in shared memory as f32; per
// tile, thread (row r, parity hp) dots cache row r with heads hp, hp + 2,
// ...; a warp per head takes the tile's max and sum into the running m and
// l (shared memory) and the rescale exp(m_old - m_new); thread (column
// pair cp, head lane hl) rescales and accumulates p . V for heads hl,
// hl + R, ... in registers. kLse: lse (B, KV, G) is written beside the
// output.
template <int D, bool kPaged, bool kQ8, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_f32_kernel(const float* __restrict__ q,
                        const void* __restrict__ k,
                        const void* __restrict__ v,
                        const __nv_bfloat16* __restrict__ k_scale,
                        const __nv_bfloat16* __restrict__ v_scale,
                        long long nscale,
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
  constexpr int kS = stages<D, kQ8, float>();
  constexpr int kTile = 2 * kSplit * LD;    // K rows, then V rows
  // a stage: an f32 tile, or an int8 one (Q8)
  constexpr int kStage = kQ8 ? Q8<D>::kBytes
                             : kTile * static_cast<int>(sizeof(float));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  float* qtile = reinterpret_cast<float*>(ring + kS * kStage);
  float* qs = qtile + (kQ8 ? kTile : 0);    // int8: the dequantized tile,
  float* ps = qs + kGroup * D;              // then q (kGroup x D), scores
  float* ml = ps + kGroup * kPS;            // and p (kGroup x kPS), and
                                            // kGroup running max, sum, and
                                            // the tile's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Work wk(kv_len, S, nsplit, KV, G);
  const int b = blockIdx.z;
  const int h = wk.h;
  const int ng = wk.ng;
  float* o = out + (wk.bh * G + wk.g0) * D;
  float* lo = kLse ? lse + wk.bh * G + wk.g0 : nullptr;
  if (blockIdx.x >= max(wk.nwork, 1)) return;
  if (wk.nwork == 0) {                      // kv_len 0: zeros (lse -inf)
    for (int i = tid; i < ng * D; i += kThreads) o[i] = 0.f;
    if constexpr (kLse)
      for (int i = tid; i < ng; i += kThreads) lo[i] = -INFINITY;
    return;
  }
  const int steps = wk.ntile;
  const int* bt = kPaged ? block_tables + static_cast<long long>(b) * nblk
                         : nullptr;
  auto stage = [&](int j) { return ring + j % kS * kStage; };
  auto issue = [&](int j) {                 // tile j's rows into its stage
    if (j >= steps) return;
    const int t0 = wk.t0(j);
    const int n = wk.rows(j);
    if constexpr (kQ8) {
      Q8<D>::issue(stage(j), static_cast<const signed char*>(k), k_scale,
                   static_cast<const signed char*>(v), v_scale, nscale, n,
                   [&](int, int r) {
                     return cache_row<kPaged>(bt, page, b, S, t0 + r) * KV +
                            h;
                   });
      return;
    }
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* ks = reinterpret_cast<float*>(stage(j));
    for (int c = tid; c < kSplit * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int e = c % kChunks * 4;
      const bool ok = r < n;                // rows past the length read 0
      const long long at =
          ok ? (cache_row<kPaged>(bt, page, b, S, t0 + r) * KV + h) * D + e
             : 0;
      cp_async16(smem_addr(ks + r * LD + e), kf + at, ok);
      cp_async16(smem_addr(ks + kSplit * LD + r * LD + e), vf + at, ok);
    }
  };
  for (int c = tid; c < ng * kChunks; c += kThreads)  // the heads' q rows
    cp_async16(smem_addr(qs + c * 4), q + (wk.bh * G + wk.g0) * D + c * 4,
               true);
  if (tid < kGroup) {                       // a fresh softmax
    ml[tid] = -INFINITY;
    ml[kGroup + tid] = 0.f;
  }
  if constexpr (kS == 1) {
    cp_async_commit();
  } else {
#pragma unroll
    for (int j = 0; j < kS - 1; ++j) {      // q rides with tile 0
      issue(j);
      cp_async_commit();
    }
  }
  const bool direct = wk.nwork == 1;
  const int stride = part_stride(G, D);
  float* pbh = part + wk.cta() * nsplit * stride;
  float* pb = pbh + blockIdx.x * stride;
  const int cp = tid % kPairs;              // P.V: column pair cp, heads
  const int hl = kAllPV || tid < R * kPairs ? tid / kPairs : kGroup;
  float a0[kPer], a1[kPer];                 // hl, hl + R, ...
#pragma unroll
  for (int i = 0; i < kPer; ++i) a0[i] = a1[i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    if constexpr (kS == 1) {
      __syncthreads();                      // tile it - 1 is done
      issue(it);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      cp_async_wait<kS - 2>();              // tile it's rows have landed
      __syncthreads();                      // ... and tile it - 1 is done
      issue(it + kS - 1);
      cp_async_commit();
    }
    const float* ks = kQ8 ? qtile : reinterpret_cast<const float*>(stage(it));
    if constexpr (kQ8) {
      Q8<D>::dequant(stage(it), qtile, qtile + kSplit * LD, LD);
      __syncthreads();
    }
    const float* vs = ks + kSplit * LD;
    const int n = wk.rows(it);
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
    // the tile's softmax: warp w takes heads w, w + 4, ...; row 0 of a
    // tile is valid, so the max is finite and masked rows get p = 0
    for (int g = warp; g < ng; g += kWarps) {
      float* pr = ps + g * kPS;
      const float s0 = pr[lane];
      const float s1 = pr[lane + 32];
      const float mo = ml[g];
      const float m = fmaxf(mo, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m);
      const float p1 = expf(s1 - m);
      const float l = warp_sum(p0 + p1);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      if (lane == 0) {
        const float al = expf(mo - m);      // 0 on the first tile
        ml[g] = m;
        ml[kGroup + g] = fmaf(ml[kGroup + g], al, l);
        ml[2 * kGroup + g] = al;
      }
    }
    __syncthreads();
    {  // P.V: rows past n add 0: their p is 0 and their V rows are zeros
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (hl + R * i < ng) {
          const float al = ml[2 * kGroup + hl + R * i];
          a0[i] *= al;
          a1[i] *= al;
        }
      }
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
    }
  }
  // the output (one working split) or the split's partials
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = hl + R * i;
    if (g < ng) {
      const int at = g * D + 2 * cp;
      if (direct) {
        const float d = fmaxf(ml[kGroup + g], 1e-30f);
        store_pair(o + at, __fdividef(a0[i], d), __fdividef(a1[i], d));
      } else {
        store_pair(pb + at, a0[i], a1[i]);
      }
    }
  }
  if (tid < ng) {
    if (!direct) {
      pb[ng * D + tid] = ml[tid];
      pb[ng * D + ng + tid] = ml[kGroup + tid];
    } else if constexpr (kLse) {
      lo[tid] = ml[tid] + logf(ml[kGroup + tid]);
    }
  }
  if (!direct)
    merge_if_last<D, false, kLse>(
        pbh, stride, tickets + wk.cta() * ticket_stride(nsplit), o, lo, ng,
        wk.nwork, nsplit, reinterpret_cast<float*>(smem_raw));
}

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;          // int8 pools only
  const void* v_scale;
  long long nscale;             // ... and their scales' count
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

// The splits a plan may give a request that can hold S positions: one to
// one a 64-row tile.
bool plan_ok(long long S, int nsplit) {
  const long long tiles = S > kSplit ? (S + kSplit - 1) / kSplit : 1;
  return nsplit >= 1 && nsplit <= tiles;
}

template <typename T, typename TO, typename Kernel>
int launch_split(Kernel kernel, size_t smem, const SplitArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int ngroups = (a.G + kGroup - 1) / kGroup;
  kernel<<<dim3(a.nsplit, a.KV * ngroups, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), a.k, a.v,
      static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale), a.nscale, a.kv_len,
      a.block_tables,
      static_cast<TO*>(a.out), a.lse, a.part, a.tickets, a.KV, a.G, a.S,
      a.page, a.nblk, a.nsplit, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory: the tile loop's (the ring, q, p or scores, the softmax's
// sums), which the merge reuses.
template <int D, bool kPaged, bool kQ8, bool kLse>
int run_split(const SplitArgs& a, bool bf16) {
  constexpr size_t q8 = kQ8 ? Q8<D>::kBytes : 0;  // an int8 stage
  if (bf16) {
    constexpr int kS = stages<D, kQ8, __nv_bfloat16>();
    constexpr size_t tile = sizeof(__nv_bfloat16) * 2 * kSplit * (D + 8);
    constexpr size_t smem = (kQ8 ? kS * q8 + tile : kS * tile) +
        sizeof(__nv_bfloat16) * (kGroup * (D + 8) + 2 * kGroup * (kSplit + 8)) +
        sizeof(float) * 2 * kWarps * kGroup;
    static_assert(smem >= sizeof(float) * kMergeFloats, "the merge fits");
    return launch_split<__nv_bfloat16,
                        std::conditional_t<kLse, float, __nv_bfloat16>>(
        flash_decode_mma_kernel<D, kPaged, kQ8, kLse>, smem, a);
  }
  constexpr int kS = stages<D, kQ8, float>();
  constexpr size_t tile = sizeof(float) * 2 * kSplit * (D + 4);
  constexpr size_t smem = (kQ8 ? kS * q8 + tile : kS * tile) +
      sizeof(float) * (kGroup * D + kGroup * (kSplit + 4) + 3 * kGroup);
  static_assert(smem >= sizeof(float) * kMergeFloats, "the merge fits");
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
// nsplit: the plan's splits a request (decode_plan), 1 to ceil(S / 64),
// which the caller sized part for: f32 scratch of B * KV * ceil(G / 16) *
// nsplit * part_stride(G, D) floats (unused, and may be null, when nsplit
// is 1); tickets: B * KV * ceil(G / 16) * ticket_stride(nsplit) int32
// zeros (ceil(nsplit / 8) + 1 a CTA row), left zero. The grid
// is (nsplit, KV * ceil(G / 16), B). Returns cudaGetLastError() after the
// launch.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, int is_bf16,
                                   const int* kv_len, void* out, void* part,
                                   void* tickets, int B, int KV, int G, int D,
                                   int S, int nsplit, float scale,
                                   void* stream) {
  if (G < 1 || S < 0 || !plan_ok(S, nsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, nullptr, nullptr, 0, kv_len, nullptr, out, nullptr,
                    static_cast<float*>(part), static_cast<int*>(tickets), B,
                    KV, G, S, 0, 0, nsplit, scale,
                    static_cast<cudaStream_t>(stream)};
  return split_by_dim<false, false>(a, D, is_bf16 != 0);
}

// The log-sum-exp instance, contiguous caches: as flash_decode_launch, but
// D in {64, 80, 128, 256}, out (B, KV, G, D) is f32 whatever q's dtype, and
// lse (B, KV, G) f32 receives m + log(l) (-inf, beside a zero output,
// where kv_len is 0).
extern "C" int flash_decode_lse_launch(const void* q, const void* k,
                                       const void* v, int is_bf16,
                                       const int* kv_len, void* out,
                                       void* lse, void* part, void* tickets,
                                       int B, int KV, int G, int D, int S,
                                       int nsplit, float scale,
                                       void* stream) {
  if (G < 1 || S < 0 || !plan_ok(S, nsplit) || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, nullptr, nullptr, 0, kv_len, nullptr, out,
                    static_cast<float*>(lse), static_cast<float*>(part),
                    static_cast<int*>(tickets), B, KV, G, S, 0, 0, nsplit,
                    scale, static_cast<cudaStream_t>(stream)};
  return split_by_dim<false, false, true>(a, D, is_bf16 != 0);
}

// Page pools. q (B, KV, G, D) and k, v (P, page, KV, D), 16-byte aligned;
// block_tables (B, nblk) int32, each entry a page of the pools; kv_len (B,)
// int32, at most nblk * page counted; out (B, KV, G, D); q, k, v and out
// share one dtype, f32 or bf16 (is_bf16). D in {16, 32, 64, 128}, any
// G >= 1, any page >= 1. nsplit: the plan's, 1 to ceil(nblk * page / 64);
// part and tickets as for flash_decode_launch. Returns cudaGetLastError()
// after the launch.
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
      block_tables == nullptr || !plan_ok(S, nsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, nullptr, nullptr, 0, kv_len, block_tables, out,
                    nullptr, static_cast<float*>(part),
                    static_cast<int*>(tickets), B,
                    KV, G, static_cast<int>(S), page, nblk, nsplit, scale,
                    static_cast<cudaStream_t>(stream)};
  return split_by_dim<true, false>(a, D, is_bf16 != 0);
}

// int8 page pools: codes k, v (P, page, KV, D) int8, 16-byte aligned;
// scales k_scale, v_scale (P, page, KV, 1) bf16, 4-byte aligned, nscale =
// P * page * KV of them; q and out (B, KV, G, D) in one dtype, f32 or bf16
// (is_bf16); the rest as for flash_decode_paged_launch. Each entry is
// attended as bf16(code * scale).
extern "C" int flash_decode_paged_q8_launch(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, long long nscale, int is_bf16, const int* kv_len,
    const int* block_tables, void* out, void* part, void* tickets, int B,
    int KV, int G, int D, int page, int nblk, int nsplit, float scale,
    void* stream) {
  const long long S = static_cast<long long>(page) * nblk;
  if (G < 1 || page < 1 || nblk < 0 || S > (1 << 30) ||
      block_tables == nullptr || k_scale == nullptr || v_scale == nullptr ||
      !plan_ok(S, nsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, k_scale, v_scale, nscale, kv_len, block_tables, out,
                    nullptr, static_cast<float*>(part),
                    static_cast<int*>(tickets), B,
                    KV, G, static_cast<int>(S), page, nblk, nsplit, scale,
                    static_cast<cudaStream_t>(stream)};
  return split_by_dim<true, true>(a, D, is_bf16 != 0);
}
