// flash_decode: single-query GQA decode attention, over a contiguous KV
// cache (split-K over the cache's rows) or over a page pool through
// per-request block tables.
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
// dtype (split-K: by div.approx, within 2 ulp): the arithmetic of the
// Pallas bodies. Unlike them, kv_len is per request ((B,) int32; the
// reference takes one shared length), and rows at or past kv_len[b] are
// never read, so a lane engine's 1 K-row stripes cost what their filled
// part does.
// Contiguous caches are (B, S, KV, D); paged pools are (P, page, KV, D)
// with block_tables (B, nblk) mapping position t to page
// block_tables[b, t / page], row t % page. Entry 0 is the scratch page;
// positions >= kv_len are masked, so scratch entries and unwritten page
// tails contribute nothing. A request with kv_len 0 gets zeros.
//
// Layout: q (B, KV, G, D) and out (B, KV, G, D), the reference's.
//
// What bounds it on the H100: bytes. A decode step reads each K/V row once
// per KV head and does 4 * G * D flops on its 4 * D bytes (bf16), G flops a
// byte (9 for starcoder2-7b), far below the card's ratio even at f32's 67
// TFLOP/s. So the design has to keep enough rows in flight on all 132 SMs.
//
// Contiguous caches, split-K: one CTA of 128 threads per (split of
// kSplit = 64 cache rows, KV head, request), so a (8, 4) batch over a
// 1056-row cache is 17 x 32 CTAs, and a split that starts at or past
// kv_len[b] exits before reading anything: the grid follows the cache's S,
// never kv_len, and the host never reads kv_len. A CTA copies its K and V
// rows into shared memory in their storage type with 16-byte cp.async
// copies, once, and serves all G query heads from them in groups of
// kGroup = 16 (any G). bf16 (flash_decode_mma_kernel): the group's q rows
// are the A operand of mma.sync m16n8k16, so each warp scores 16 keys for
// all 16 heads at once (exact bf16 products summed in f32), the split's
// max and sum cross the warps through shared memory, and p . V runs on the
// tensor cores with p split into bf16 hi + lo as in flash_prefill (p to
// ~16 mantissa bits). f32 (flash_decode_f32_kernel, the f32 consistency
// runs): plain FMA, each thread dotting a cache row with up to 8 heads'
// q rows and accumulating p . V for one column pair of its heads. Each
// split writes f32 partials (acc[G][D], m[G], l[G]) to scratch from the
// wrapper; the last CTA of each (request, KV head) to finish, found by an
// atomic ticket, merges its working splits (acc and l scaled by
// exp(m_s - max m)) and resets the ticket for the next launch: one launch
// a call. A request whose kv_len fits one split writes its output
// directly.
//
// Paged (flash_decode_kernel, kPaged; its split-K redesign is still to
// come): one CTA of 128 threads per (request, KV head) loads its G <= 16
// query rows once into shared memory, then walks K/V in tiles of 32 rows
// staged through shared memory as f32, so each K/V row is read once for all
// G query heads. A warp owns one query head's 32 scores of a tile (one per
// lane), so the tile's max and sum are warp shuffles; K rows are padded to
// D + 1 floats so the lanes' dot products hit distinct banks. Each thread
// then owns one of the D output columns for G / (128 / D) query heads, in
// registers. B * KV CTAs (32 for the serving batch) leave most of the 132
// SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_ops.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // paged: K/V rows per tile, one per lane
constexpr int kMaxG = 16;        // paged: query heads per KV head
constexpr float kNegInf = -1e30f;
constexpr int kSplit = 64;       // contiguous: cache rows per CTA
constexpr int kGroup = 16;       // contiguous: query heads per pass
static_assert(2 * kSplit == kThreads, "a thread per (row, head parity)");
// The split-K kernels' launch bounds name a minimum of one CTA an SM:
// without it ptxas spills registers at some D to raise occupancy.

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

// ---- contiguous cache, split-K ----

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
// exp(m_s - max m), and column pairs j, j + 32, ...
constexpr int kMergeHeads = 4;
template <int D, bool kLog2, typename T>
__device__ __forceinline__ void merge_if_last(const float* part,
                                              int* tickets, T* o, int G,
                                              int nwork, int nsplit,
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
      const float d = fmaxf(warp_sum(l[i]), 1e-30f);
      if (i >= nh) continue;
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
// w computes column tiles w * kNTW .. (V by ldmatrix.trans).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ kv_len,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ tickets,
                        int KV, int G, int S, int nsplit, float scale) {
  constexpr int LD = D + 8;                 // a K/V/q row, padded 16 bytes
  constexpr int kChunks = D / 8;            // 16-byte chunks a row
  constexpr int kRowStep = kThreads / kChunks;
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
  __nv_bfloat16* o = out + bh * G * D;
  if (split >= max(nwork, 1)) return;
  if (nwork == 0) {                         // kv_len 0: zeros
    for (int i = tid; i < G * D; i += kThreads) store(o + i, 0.f);
    return;
  }
  const int n = min(kSplit, len - split * kSplit);
  const int cr = tid / kChunks;             // this thread's copies: rows
  const int ce = tid % kChunks * 8;         // cr + i kRowStep, column ce
  const long long row = static_cast<long long>(KV) * D;
  const long long at = (static_cast<long long>(b) * S + split * kSplit) *
                       row + h * D + ce;
#pragma unroll
  for (int r = cr; r < kSplit; r += kRowStep) {
    const bool ok = r < n;                  // rows past the length read 0
    cp_async16(smem_addr(ks + r * LD + ce), k + (ok ? at + r * row : 0), ok);
    cp_async16(smem_addr(vs + r * LD + ce), v + (ok ? at + r * row : 0), ok);
  }
  auto load_q = [&](int g0) {               // heads past G read as 0
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
    if (!direct && tid < ng) {
      float m = rmax[tid], l = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        m = fmaxf(m, rmax[w * kGroup + tid]);
        l += rsum[w * kGroup + tid];
      }
      pb[G * D + g0 + tid] = m;
      pb[G * D + G + g0 + tid] = l;
    }
    __syncthreads();                        // q, p and the sums are reused
  }
  if (!direct) merge_if_last<D, true>(part, tickets, o, G, nwork, nsplit, bh);
}

// f32 caches: plain f32 FMA, which the 1e-5 check of the f32 consistency
// runs needs. Per group of kGroup heads (q rows in shared memory as f32),
// thread (row r, parity hp) dots cache row r with heads hp, hp + 2, ...;
// a warp per head takes the split's max and sum; thread (column pair cp,
// head lane hl) accumulates p . V for heads hl, hl + R, ... in registers.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ tickets, int KV, int G, int S,
                        int nsplit, float scale) {
  constexpr int LD = D + 4;                 // a shared row, padded 16 bytes
  constexpr int kChunks = D / 4;            // 16-byte chunks a row
  constexpr int kPairs = D / 2;             // P.V: a thread per column pair
  constexpr int R = kThreads / kPairs;      // ... and head lane
  constexpr int kPer = (kGroup + R - 1) / R;
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
  if (split >= max(nwork, 1)) return;
  if (nwork == 0) {                         // kv_len 0: zeros
    for (int i = tid; i < G * D; i += kThreads) o[i] = 0.f;
    return;
  }
  const int t0 = split * kSplit;
  const int n = min(kSplit, len - t0);
  const long long row = static_cast<long long>(KV) * D;
  const float* kg = k + (static_cast<long long>(b) * S + t0) * row + h * D;
  const float* vg = v + (static_cast<long long>(b) * S + t0) * row + h * D;
  for (int c = tid; c < kSplit * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int e = c % kChunks * 4;
    const bool ok = r < n;                  // rows past the length read 0
    cp_async16(smem_addr(ks + r * LD + e), ok ? kg + r * row + e : kg, ok);
    cp_async16(smem_addr(vs + r * LD + e), ok ? vg + r * row + e : vg, ok);
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
      const int hl = tid / kPairs;
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
    }
    __syncthreads();                        // qs, ps, ml are reused next
  }
  if (!direct) merge_if_last<D, false>(part, tickets, o, G, nwork, nsplit, bh);
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

template <int D, typename T>
int run_paged(const Args& a) {
  const size_t smem = sizeof(float) *
      (a.G * D + kTile * (D + 1) + kTile * D + a.G * kTile + 3 * a.G);
  auto kernel = flash_decode_kernel<D, T, true>;
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

template <typename T>
int paged_by_dim(const Args& a, int D) {
  switch (D) {
    case 16: return run_paged<16, T>(a);
    case 32: return run_paged<32, T>(a);
    case 64: return run_paged<64, T>(a);
    case 128: return run_paged<128, T>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* out;
  float* part;
  int* tickets;
  int B, KV, G, S, nsplit;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename Kernel>
int launch_split(Kernel kernel, size_t smem, const SplitArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.nsplit, a.KV, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.kv_len, static_cast<T*>(a.out), a.part,
      a.tickets, a.KV, a.G, a.S, a.nsplit, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_split(const SplitArgs& a, bool bf16) {
  if (bf16) {
    constexpr size_t smem = sizeof(__nv_bfloat16) *
        ((2 * kSplit + kGroup) * (D + 8) + 2 * kGroup * (kSplit + 8)) +
        sizeof(float) * 2 * kWarps * kGroup;
    return launch_split<__nv_bfloat16>(flash_decode_mma_kernel<D>, smem, a);
  }
  constexpr size_t smem = sizeof(float) *
      (2 * kSplit * (D + 4) + kGroup * D + kGroup * (kSplit + 4) +
       2 * kGroup);
  return launch_split<float>(flash_decode_f32_kernel<D>, smem, a);
}

int split_by_dim(const SplitArgs& a, int D, bool bf16) {
  switch (D) {
    case 16: return run_split<16>(a, bf16);
    case 32: return run_split<32>(a, bf16);
    case 64: return run_split<64>(a, bf16);
    case 128: return run_split<128>(a, bf16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Contiguous caches. q (B, KV, G, D) and k, v (B, S, KV, D), 16-byte
// aligned; kv_len (B,) int32; out (B, KV, G, D); q, k, v and out share one
// dtype, f32 or bf16 (is_bf16). D in {16, 32, 64, 128}, any G >= 1.
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
  if (G < 1 || S < 0 || nsplit != (S > kSplit ? (S + kSplit - 1) / kSplit
                                               : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, kv_len, out, static_cast<float*>(part),
                    static_cast<int*>(tickets), B, KV, G, S, nsplit, scale,
                    static_cast<cudaStream_t>(stream)};
  return split_by_dim(a, D, is_bf16 != 0);
}

// Page pools. q (B, KV, G, D); k, v (P, page, KV, D); block_tables
// (B, nblk) int32; kv_len (B,) int32; out (B, KV, G, D); one dtype, f32 or
// bf16 (is_bf16). D in {16, 32, 64, 128}, G <= 16. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_decode_paged_launch(const void* q, const void* k,
                                         const void* v, int is_bf16,
                                         const int* kv_len,
                                         const int* block_tables, void* out,
                                         int B, int KV, int G, int D,
                                         int page, int nblk, float scale,
                                         void* stream) {
  if (G < 1 || G > kMaxG || block_tables == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, kv_len, block_tables, out, B, KV, G, page, nblk,
               scale, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? paged_by_dim<__nv_bfloat16>(a, D)
                 : paged_by_dim<float>(a, D);
}
