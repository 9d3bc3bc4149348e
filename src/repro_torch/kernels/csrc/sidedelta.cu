// sidedelta: per-request sparse side delta of multi-tenant SHiRA serving.
//
// Replaces the TPU kernel src/repro/kernels/sidedelta.py:sidedelta_rows
// (Pallas body _sidedelta_kernel). For request b with adapter a = ids[b]:
//
//   out[b, s, c] = sum over entries k of adapter a in column c of
//                  x[b, s, rows[a, k]] * vals[a, k] * scale[a]
//
// and out[b] = 0 when ids[b] is outside [0, A). out is f32; the caller adds
// it to x @ W.
//
// Layout (built once per adapter at registration by
// repro_torch.kernels.ops.sidedelta_table): each adapter's entries are
// sorted by column, then row, with duplicate coordinates summed; colptr
// (A, m + 1) holds each column's first entry, and colptr[a, m] is the
// adapter's valid count. Entries past it are padding and are never read, so
// a padded table costs what an unpadded one does.
//
// What bounds it on the H100: the gathers. Each entry multiplies the x
// values of one row by one value for every token of its adapter's
// requests; the tables (2-4 + 1-4 bytes an entry, K ~ 2% of n * m) and x
// are read once from device memory, but the gathered x values (K * tokens
// of them) come from L2, and that traffic, not the 2 * K * tokens f32
// operations, sets the time. Two paths; the wrapper's rule
// (kernels/sidedelta.py: kernel_path) picks the rows path for decode
// (S == 1) and for calls of fewer than 32 tokens of one request or 64 of
// several, the tokens path otherwise, from the crossover measured on the
// card (chip_smoke.py).
//
// Rows (sidedelta_rows_kernel): one warp owns one output column of one
// request's row, its 32 lanes stride through the column's entries with
// coalesced table loads and gather x[b, s, rows[k]] from one activation
// row (at most 74 KB, in L1/L2), and reduce by shuffles in a fixed order.
// Neighbouring blocks are requests on the same columns, so requests that
// share an adapter read its table lines while they are in L2. The table
// is walked once per row: cheap for a decode batch, linear in tokens.
//
// Tokens (sidedelta_tokens_kernel): the wrapper groups the requests by
// adapter (a stable sort of ids, requests outside [0, A) last) and
// transposes x to token-minor xT (n, T), T = B * S, rows a multiple of 4
// apart, so adapter a's tokens are the range [rptr[a] * S, rptr[a + 1] *
// S) of every row of xT. One CTA of kWarps warps takes kWarps consecutive
// output columns and a tile of kTile = 128 consecutive tokens; warp w walks
// column c0 + w's entries once for the whole tile, in table order, 32 at a
// time from one coalesced load (the next 32 in flight meanwhile),
// broadcasting each (row, value) by shuffles; lane l owns tokens 4 l .. 4 l
// + 3 of the tile and gathers them as one 16-byte (f32) or 8-byte (bf16)
// load, so each entry's gather is one coalesced 512- or 256-byte read of
// consecutive tokens (in the (B, S, n) layout the same values lie n
// elements apart). The table is walked once per (adapter, token tile),
// not once per row. A tile that spans adapters is walked once for each.
// Tiles run in order across the grid (blockIdx.y), so the live slice of xT
// is one tile's n * 128 values (9.4 MB of f32 dy for dx at w_up) and stays
// in L2. The kernel is bound by the gathers in flight: few registers (two
// entries' gathers at once, six CTAs an SM) measured faster than more
// gathers a warp with fewer warps. The CTA stages its (128 x kWarps)
// outputs in shared memory and writes each token's kWarps columns as one
// 32-byte run of out (B, S, m), at the token's request's place before
// grouping; tokens of requests outside [0, A) get zeros. Each token's sum
// runs serially over its column's entries in table order: deterministic,
// independent of S and of the batch's mix, and no atomics (the rows path
// sums lane-strided partials by a shuffle tree instead).
//
// dx of the trainable delta (kernels/sidedelta.py: _SideDelta) is this
// kernel over the transposed, row-sorted table with f32 dy as x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // output columns per block
// the tokens path: tokens a lane owns, entries whose gathers a warp has in
// flight at once, and CTAs an SM that the registers must allow
constexpr int kPer = 4;
constexpr int kUnroll = 2;
constexpr int kMinBlocks = 6;
constexpr int kTile = 32 * kPer;  // tokens per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename XT, typename IT, typename VT>
__global__ void __launch_bounds__(kWarps * 32)
sidedelta_rows_kernel(const XT* __restrict__ x, const IT* __restrict__ rows,
                      const VT* __restrict__ vals,
                      const int* __restrict__ colptr,
                      const float* __restrict__ scale,
                      const int* __restrict__ ids, float* __restrict__ out,
                      int S, int n, int m, int A, long long K) {
  const int b = blockIdx.x;
  const int s = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (c >= m) return;  // uniform per warp: the shuffles below stay full
  const int a = ids[b];

  float acc = 0.f;
  if (a >= 0 && a < A) {
    const int* cp = colptr + static_cast<long long>(a) * (m + 1);
    const int k0 = cp[c];
    const int k1 = cp[c + 1];
    const IT* ra = rows + static_cast<long long>(a) * K;
    const VT* va = vals + static_cast<long long>(a) * K;
    const float sc = scale != nullptr ? scale[a] : 1.f;
    const XT* xb = x + (static_cast<long long>(b) * S + s) * n;
    // a lane takes 2-12 entries of a column: nvcc's unrolled loop ran
    // slower on the H100 at w_up's shape
#pragma unroll 1
    for (int k = k0 + lane; k < k1; k += 32) {
      const int r = static_cast<int>(ra[k]);
      const float v = to_f32(va[k]) * sc;
      acc = fmaf(to_f32(xb[r]), v, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[(static_cast<long long>(b) * S + s) * m + c] = acc;
}

// kPer consecutive tokens of one row of xT, loaded as one vector: 16 bytes
// of f32 or 8 of bf16 (the row stride is a multiple of kPer).
template <typename XT>
struct Tokens;
template <>
struct Tokens<float> {
  using Raw = float4;
  __device__ __forceinline__ static float get(const Raw& r, int i) {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
  }
};
template <>
struct Tokens<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static float get(const Raw& r, int i) {
    const unsigned w = i < 2 ? r.x : r.y;
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
};
static_assert(kPer == 4, "a lane's tokens are one 4-element vector");

// xT (n, ld) token-minor, tokens grouped by adapter, ld a multiple of kPer;
// rptr (A + 2): adapter a's requests are [rptr[a], rptr[a + 1]) of the
// grouped order, a == A the requests outside [0, A); order (B): grouped
// position -> request.
template <typename XT, typename IT, typename VT>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
sidedelta_tokens_kernel(const XT* __restrict__ xT,
                        const IT* __restrict__ rows,
                        const VT* __restrict__ vals,
                        const int* __restrict__ colptr,
                        const float* __restrict__ scale,
                        const int* __restrict__ rptr,
                        const int* __restrict__ order,
                        float* __restrict__ out, int S, int m, int A,
                        long long K, int T, int ld) {
  using Raw = typename Tokens<XT>::Raw;
  __shared__ __align__(16) float tile[kWarps][kTile + 4];  // 4: no conflicts
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kWarps;
  const int c = c0 + w;
  const int t0 = blockIdx.y * kTile;
  const int t1 = min(t0 + kTile, T);
  const int tl = t0 + lane * kPer;            // this lane's first token

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  // the first segment (adapter, or a == A) whose tokens reach past t0
  int lo = 0, hi = A;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rptr[mid + 1] * S > t0) hi = mid;
    else lo = mid + 1;
  }
  for (int a = lo; a < A && rptr[a] * S < t1; ++a) {
    if (c >= m) break;  // uniform per warp: the shuffles below stay full
    const int s0 = rptr[a] * S;
    const int s1 = rptr[a + 1] * S;
    const int* cp = colptr + static_cast<long long>(a) * (m + 1);
    const int k0 = cp[c];
    const int k1 = cp[c + 1];
    const IT* ra = rows + static_cast<long long>(a) * K;
    const VT* va = vals + static_cast<long long>(a) * K;
    const float sc = scale != nullptr ? scale[a] : 1.f;
    unsigned mine = 0;  // bit i: this lane's token i belongs to adapter a
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      mine |= (tl + i >= s0 && tl + i < s1 ? 1u : 0u) << i;
    const XT* xt = xT + tl;
    // entries 32 at a time, one per lane; the next 32 load while these
    // are served
    IT rn = 0;
    VT vn = 0;
    if (k0 + lane < k1) {
      rn = ra[k0 + lane];
      vn = va[k0 + lane];
    }
    for (int kb = k0; kb < k1; kb += 32) {
      const int nk = min(32, k1 - kb);
      const int r = static_cast<int>(rn);
      const float v = to_f32(vn) * sc;
      if (kb + 32 + lane < k1) {
        rn = ra[kb + 32 + lane];
        vn = va[kb + 32 + lane];
      }
      for (int j0 = 0; j0 < nk; j0 += kUnroll) {
        Raw xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int rj = __shfl_sync(0xffffffffu, r, j0 + u);
          xv[u] = Raw{};
          if (j0 + u < nk && mine)
            xv[u] = *reinterpret_cast<const Raw*>(
                xt + static_cast<long long>(rj) * ld);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float vj = __shfl_sync(0xffffffffu, v, j0 + u);
          if (j0 + u < nk) {
#pragma unroll
            for (int i = 0; i < kPer; ++i)
              if (mine >> i & 1u)
                acc[i] = fmaf(Tokens<XT>::get(xv[u], i), vj, acc[i]);
          }
        }
      }
    }
  }
  // tokens of requests outside [0, A), and columns without entries, keep 0
  *reinterpret_cast<float4*>(&tile[w][lane * kPer]) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  const int nc = min(kWarps, m - c0);
  for (int e = threadIdx.x; e < kTile * kWarps; e += kWarps * 32) {
    const int tt = e / kWarps;
    const int cc = e % kWarps;
    const int t = t0 + tt;
    if (t >= t1 || cc >= nc) continue;
    const long long row = static_cast<long long>(order[t / S]) * S + t % S;
    out[row * m + c0 + cc] = tile[cc][tt];
  }
}

struct Args {
  const void* x;
  const void* rows;
  const void* vals;
  const int* colptr;
  const float* scale;
  const int* ids;    // rows path
  const int* rptr;   // tokens path
  const int* order;  // tokens path
  float* out;
  int B, S, n, m, A;
  long long K;
  int ld;            // tokens path: xT's row stride
  cudaStream_t stream;
};

template <typename XT, typename IT, typename VT>
int run(const Args& g, bool tokens) {
  if (tokens) {
    const int T = g.B * g.S;   // the wrapper keeps it under 2^31
    const dim3 grid((g.m + kWarps - 1) / kWarps, (T + kTile - 1) / kTile);
    sidedelta_tokens_kernel<XT, IT, VT><<<grid, kWarps * 32, 0, g.stream>>>(
        static_cast<const XT*>(g.x), static_cast<const IT*>(g.rows),
        static_cast<const VT*>(g.vals), g.colptr, g.scale, g.rptr, g.order,
        g.out, g.S, g.m, g.A, g.K, T, g.ld);
  } else {
    const dim3 grid(g.B, (g.m + kWarps - 1) / kWarps, g.S);
    sidedelta_rows_kernel<XT, IT, VT><<<grid, kWarps * 32, 0, g.stream>>>(
        static_cast<const XT*>(g.x), static_cast<const IT*>(g.rows),
        static_cast<const VT*>(g.vals), g.colptr, g.scale, g.ids, g.out,
        g.S, g.n, g.m, g.A, g.K);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename IT>
int by_vals(const Args& g, bool tokens, int vals_int8) {
  return vals_int8 ? run<XT, IT, int8_t>(g, tokens)
                   : run<XT, IT, float>(g, tokens);
}

template <typename XT>
int by_rows(const Args& g, bool tokens, int rows_int16, int vals_int8) {
  return rows_int16 ? by_vals<XT, int16_t>(g, tokens, vals_int8)
                    : by_vals<XT, int32_t>(g, tokens, vals_int8);
}

int by_x(const Args& g, bool tokens, int x_bf16, int rows_int16,
         int vals_int8) {
  return x_bf16 ? by_rows<__nv_bfloat16>(g, tokens, rows_int16, vals_int8)
                : by_rows<float>(g, tokens, rows_int16, vals_int8);
}

}  // namespace

// Rows. x (B, S, n) f32 or bf16; rows (A, K) int32 or int16; vals (A, K)
// f32 or int8; colptr (A, m + 1) int32; scale (A,) f32 or null; ids (B,)
// int32; out (B, S, m) f32. Returns cudaGetLastError() after the launch.
extern "C" int sidedelta_launch(const void* x, int x_bf16, const void* rows,
                                int rows_int16, const void* vals,
                                int vals_int8, const int* colptr,
                                const float* scale, const int* ids,
                                float* out, int B, int S, int n, int m, int A,
                                long long K, void* stream) {
  const Args g{x,     rows, vals, colptr, scale, ids, nullptr, nullptr,
               out,   B,    S,    n,      m,     A,   K,       0,
               static_cast<cudaStream_t>(stream)};
  return by_x(g, false, x_bf16, rows_int16, vals_int8);
}

// Prefill and training. xT (n, B * S) f32 or bf16 with row stride ld (a
// multiple of 4, 16-byte aligned rows), the requests' tokens in the grouped
// order; rows, vals, colptr, scale as above; rptr (A + 2) int32 and order
// (B) int32, the grouping; out (B, S, m) f32, in the requests' own order.
// Returns cudaGetLastError() after the launch.
extern "C" int sidedelta_tokens_launch(const void* xT, int x_bf16,
                                       const void* rows, int rows_int16,
                                       const void* vals, int vals_int8,
                                       const int* colptr, const float* scale,
                                       const int* rptr, const int* order,
                                       float* out, int B, int S, int n, int m,
                                       int A, long long K, int ld,
                                       void* stream) {
  if (ld % kPer != 0 || ld < B * S)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{xT,  rows, vals, colptr, scale, nullptr, rptr, order,
               out, B,    S,    n,      m,     A,       K,    ld,
               static_cast<cudaStream_t>(stream)};
  return by_x(g, true, x_bf16, rows_int16, vals_int8);
}
