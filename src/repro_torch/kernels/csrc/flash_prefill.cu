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
// Scores and the online softmax are f32 and p is kept in f32 (in bf16 to
// ~16 mantissa bits, below), scale = 1 / sqrt(D) rounded in f32 by the
// caller, and the output is acc / max(l, 1e-30) cast to q's dtype (in bf16
// by div.approx, within 2 ulp of f32 before the cast): the arithmetic of
// the Pallas body. Causal tiles above the diagonal are
// skipped, and the tails of Sq and Skv are masked rather than padded: the
// reference's wrapper pads both to 512 (repro/kernels/ops.py:flash_prefill)
// and, bidirectional, lets the padded keys in, so the two agree
// bidirectionally only where Skv is a multiple of its kv block. Layouts are
// the model's own, read in place: q and out (B, Sq, H, D), k and v
// (B, Skv, KV, D), H = KV * G, head h = kv * G + g.
//
// What bounds it on the H100: operations. A 1024-token causal prefill of
// starcoder2-7b does 4.84 GFLOP of q . k and 4.84 of p . v a layer on ~21 MB
// of q, k, v and out, ~900 operations a byte, far above the ~295 a byte at
// which the bf16 tensor cores stop waiting for memory: the products have
// to run on the tensor cores.
//
// bf16, the serving path (flash_prefill_mma_kernel): one CTA of 4 warps
// per (64 query rows, query head, request), the causal blocks with the
// most key tiles launched first. Each warp owns 16 query rows and keeps
// their q fragments in registers for the whole walk. K and V tiles of 64
// rows stay bf16 in a 2-stage shared-memory ring filled by 16-byte
// cp.async copies from the model's layouts; rows are padded by 16 bytes so
// that ldmatrix reads them free of bank conflicts. S = q . K^T runs on
// mma.sync m16n8k16 (bf16 x bf16 -> f32: exact products summed in f32);
// the online softmax runs in the accumulator registers, row max and sum by
// quad shuffles. p stays f32 as the Pallas body keeps it: each p is split
// into hi = bf16(p) and lo = bf16(p - hi), and both go through mma.sync
// against V (ldmatrix.trans), summed in f32, so p carries ~16 mantissa
// bits (error <= 2^-17 p). That costs a third more tensor-core work than
// rounding p to bf16 alone, which would be SDPA's arithmetic, not the
// reference kernel's.
//
// f32 (flash_prefill_kernel; only the 2-layer f32 consistency checks run
// it): plain f32 FMA, since their 1e-5 check needs f32 scores. One CTA of
// 256 threads per (64 query rows, query head, request) keeps its q tile in
// shared memory and walks K/V in tiles of 32 rows. A warp owns 8 query
// rows' scores of a tile, one key per lane, so the online softmax's max
// and sum are warp shuffles; K rows are padded to D + 1 floats so the
// lanes' dot products hit distinct banks. Each thread then owns one output
// column for 64 / (256 / D) query rows in registers. Where D does not divide
// 256 (D = 80: 3 rows a pass over 240 threads), the first (256 / D) * D
// threads own the columns, 22 passes cover the 64 rows, and the passes past
// row 63 are skipped; where it does (16, 32, 64, 128) every thread owns a
// column and 64 / (256 / D) passes cover the tile exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 32;          // key rows per tile, one per lane
constexpr float kNegInf = -1e30f;

constexpr int kMmaThreads = 128;  // bf16: 4 warps of 16 query rows
constexpr int kMmaBQ = 64;        // query rows per CTA
constexpr int kMmaBK = 64;        // key rows per tile
constexpr int kPad = 8;           // bf16 a shared row beyond D: 16 bytes
static_assert(kMmaBQ == kMmaBK, "q's tile is staged in a K stage");
// The mma kernel's launch bounds name a minimum of one CTA an SM: without
// it ptxas spills registers at D = 16 to raise occupancy.

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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
  constexpr int kRows = (kBQ + R - 1) / R;   // passes over the tile
  // every thread owns a column and the passes tile the rows exactly
  constexpr bool kExact = R * D == kThreads && kRows * R == kBQ;
  const int d = tid % D;
  const int r0 = tid / D;                    // < R for the column owners
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
      if (!kExact && (r0 >= R || r >= kBQ)) continue;
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
    if ((kExact || r0 < R) && r < nq) {
      store(out + ((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + d,
            acc[i] / fmaxf(ls[r], 1e-30f));
    }
  }
}

// Fragments (PTX ISA, mma.m16n8k16): lane 4 grp + qd holds accumulators
// c0, c1 at (row grp, columns 2 qd, 2 qd + 1) and c2, c3 at row grp + 8;
// an A fragment is two such 16 x 8 halves side by side, so the score
// accumulators of keys 16 j .. 16 j + 15 are p's A fragment as they stand.
// Shared memory: two stages of K and V tiles; q's tile is staged in the
// second K stage, read into registers before that stage is first filled.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                         int H, int KV, int causal, float scale) {
  constexpr int LD = D + kPad;              // a shared row, in bf16
  constexpr int kChunks = D / 8;            // 16-byte chunks a row
  constexpr int kRowStep = kMmaThreads / kChunks;  // rows a copy pass
  // every thread copies and the passes tile the 64 rows exactly (D = 16,
  // 32, 64, 128); else (D = 80: 12 rows a pass over 120 threads) the
  // threads past kRowStep * kChunks copy nothing and each copy stops at the
  // tile's last row, so that no row has two owners and none is written past
  // the tile
  constexpr bool kExact =
      kRowStep * kChunks == kMmaThreads && kMmaBK % kRowStep == 0;
  constexpr int kTile = kMmaBK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 2 stages
  __nv_bfloat16* vs = ks + 2 * kTile;       // 2 stages
  __nv_bfloat16* qs = ks + kTile;           // K's second stage, at first

  const int h = blockIdx.x;
  // causal blocks with the most key tiles first, over all heads
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int qd = lane & 3;
  const int nq = min(kMmaBQ, Sq - q0);
  // keys a causal query row of this tile can see end at its last row
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int ntiles = (kv_end + kMmaBK - 1) / kMmaBK;
  const long long qrow = static_cast<long long>(H) * D;
  const long long kvrow = static_cast<long long>(KV) * D;
  const int cr = tid / kChunks;             // this thread's copies: rows
  const int ce = tid % kChunks * 8;         // cr + i kRowStep, column ce
  const bool copier = kExact || cr < kRowStep;
  const __nv_bfloat16* qg =
      q + (static_cast<long long>(b) * Sq + q0) * qrow + h * D + ce;
  const __nv_bfloat16* kg =
      k + static_cast<long long>(b) * Skv * kvrow + hk * D + ce;
  const __nv_bfloat16* vg =
      v + static_cast<long long>(b) * Skv * kvrow + hk * D + ce;

  auto load_tile = [&](int t) {             // rows past kv_end read as 0
    const uint32_t kd = smem_addr(ks + (t & 1) * kTile + cr * LD + ce);
    const uint32_t vd = smem_addr(vs + (t & 1) * kTile + cr * LD + ce);
    const int t0 = t * kMmaBK + cr;
#pragma unroll
    for (int r = 0; r < kMmaBK; r += kRowStep) {
      if (!kExact && (!copier || cr + r >= kMmaBK)) continue;
      const bool ok = t0 + r < kv_end;
      const long long off = ok ? (t0 + r) * kvrow : 0;
      cp_async16(kd + r * LD * 2, kg + off, ok);
      cp_async16(vd + r * LD * 2, vg + off, ok);
    }
  };
#pragma unroll
  for (int r = 0; r < kMmaBQ; r += kRowStep) {
    if (!kExact && (!copier || cr + r >= kMmaBQ)) continue;
    const bool ok = cr + r < nq;
    cp_async16(smem_addr(qs + (cr + r) * LD + ce),
               qg + (ok ? (cr + r) * qrow : 0), ok);
  }
  if (ntiles > 0) load_tile(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];                   // this warp's 16 q rows
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + (lane & 15)) * LD +
                                  kk * 16 + (lane >> 4) * 8));
  __syncthreads();                          // q's stage is K's from here

  float o[D / 8][4];                        // the 16 rows' outputs
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // running max (in units of log2, scores times scale * log2(e)) and sum
  // of rows grp and grp + 8
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * 1.44269504088896341f;
  const int row0 = q0 + warp * 16 + grp;    // query position of c0, c1

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + (t & 1) * kTile;
    const __nv_bfloat16* vt = vs + (t & 1) * kTile;
    const int t0 = t * kMmaBK;

    float s[kMmaBK / 8][4];                 // keys 8 j .. 8 j + 7
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kMmaBK / 16; ++j) {
        uint32_t kb[4];                     // keys 16 j .. 16 j + 15
        ldmatrix_x4(kb, smem_addr(kt + (j * 16 + (lane >> 4) * 8 +
                                         (lane & 7)) * LD +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * j], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * j + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale, mask and the online softmax of this warp's 16 rows; masked
    // scores are -inf, so their p is 0 whatever the running max
    const bool edge = t0 + kMmaBK > Skv ||
                      (causal && t0 + kMmaBK - 1 > q0 + warp * 16);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int key = t0 + j * 8 + qd * 2 + (e & 1);
          if (key >= Skv || (causal && key > row0 + (e >> 1) * 8))
            x = -INFINITY;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = exp2f(m0 - mx0);
    const float c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + quad_sum(sum0);
    l1 = l1 * c1 + quad_sum(sum1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }

    // o += p . V with p = hi + lo
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t vb[4];                     // columns 16 j .. 16 j + 15
        ldmatrix_x4_trans(vb, smem_addr(vt + (kk * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * LD +
                                        j * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * j], ph, vb[0], vb[1]);
        mma_bf16(o[2 * j + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * j], pl, vb[0], vb[1]);
        mma_bf16(o[2 * j + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();                        // this stage is refilled next
  }

  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  const int r = warp * 16 + grp;
  __nv_bfloat16* og = out + (static_cast<long long>(b) * Sq + q0) * qrow +
                      h * D + qd * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r < nq)
      *reinterpret_cast<__nv_bfloat162*>(og + r * qrow + j * 8) =
          __floats2bfloat162_rn(__fdividef(o[j][0], d0),
                                __fdividef(o[j][1], d0));
    if (r + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(og + (r + 8) * qrow + j * 8) =
          __floats2bfloat162_rn(__fdividef(o[j][2], d1),
                                __fdividef(o[j][3], d1));
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

template <int D>
int run_f32(const Args& a) {
  constexpr size_t smem = sizeof(float) *
      (kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK + 3 * kBQ);
  auto kernel = flash_prefill_kernel<D, float>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.Sq,
      a.Skv, a.H, a.KV, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_bf16(const Args& a) {
  constexpr size_t smem = sizeof(__nv_bfloat16) * 4 * kMmaBK * (D + kPad);
  auto kernel = flash_prefill_mma_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.H, (a.Sq + kMmaBQ - 1) / kMmaBQ, a.B);
  kernel<<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), a.Sq, a.Skv, a.H, a.KV, a.causal,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

int by_dim(const Args& a, int D, bool bf16) {
  switch (D) {
    case 16: return bf16 ? run_bf16<16>(a) : run_f32<16>(a);
    case 32: return bf16 ? run_bf16<32>(a) : run_f32<32>(a);
    case 64: return bf16 ? run_bf16<64>(a) : run_f32<64>(a);
    case 80: return bf16 ? run_bf16<80>(a) : run_f32<80>(a);
    case 128: return bf16 ? run_bf16<128>(a) : run_f32<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, D); k, v (B, Skv, KV, D); out (B, Sq, H, D); one dtype for
// all, f32 or bf16 (is_bf16), each pointer 16-byte aligned. H a multiple of
// KV, D in {16, 32, 64, 80, 128}, causal 0 or 1. Returns cudaGetLastError()
// after the launch.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, int is_bf16, void* out,
                                    int B, int Sq, int Skv, int H, int KV,
                                    int D, int causal, float scale,
                                    void* stream) {
  if (KV < 1 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, Sq, Skv, H, KV, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return by_dim(a, D, is_bf16 != 0);
}
