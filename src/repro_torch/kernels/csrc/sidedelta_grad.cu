// sidedelta_dvals: the gradient of the per-request sparse side delta with
// respect to each adapter's table values, for multi-adapter training.
//
// The TPU code has no kernel for it: the JAX trainer differentiates the XLA
// twin of the sidedelta kernel, src/repro/kernels/sidedelta.py:
// _sidedelta_xla (selected by layers.sidedelta_backend("xla")). The
// forward is out[b, s, c] = sum_k x[b, s, rows[a, k]] * vals[a, k] over
// adapter a = ids[b]'s entries in column c, so
//
//   dvals[a, k] = sum over requests b with ids[b] == a, and rows s, of
//                 x[b, s, rows[a, k]] * dy[b, s, c(k)]
//
// where c(k) is entry k's column. (The gradient with respect to x is the
// forward kernel, sidedelta.cu, run over the row-sorted transposed table.)
//
// Layout. The table is the column-sorted one the forward reads (built by
// repro_torch.kernels.ops.sidedelta_table): rows (A, K) int32, colptr
// (A, m + 1) with colptr[a, m] the valid count. The wrapper groups the
// requests by adapter (a stable sort of ids) and transposes x and dy to
// token-minor order, xT (n, T) and dyT (m, T) with T = B * S and row
// strides ldx and ldy, so adapter a owns the token range
// [rptr[a] * S, rptr[a + 1] * S). Token-minor rows make every gather below
// a coalesced read of consecutive tokens.
//
// What bounds it on the H100: 2 * T_a * K f32 multiply-adds per adapter
// (T_a its tokens) at the f32 rate, against K * 4 bytes written and x and
// dy read once. In practice the gathers set the pace: every entry reads
// T_a values of one x row (1 KB in bf16 at T_a = 512), from L2 (one
// adapter's xT is 4.7 MB at starcoder2-7b's w_up).
//
// A design of one warp a column that walked the column's entries one at a
// time, each lane loading one token's x (2 bytes) and dy (4 bytes) per
// step of an unknown trip count and reducing every entry by five shuffles,
// waited a full L2 round trip per step: it ran at ~4% of the bound. Here:
//   - one warp still owns one output column c of one adapter (grid x:
//     columns, kWarps a block; grid y: adapters), so each entry has one
//     writer: no atomics, deterministic results;
//   - the column's dy run stays in registers for the whole walk: a tile of
//     32 * V * J tokens (V consecutive tokens a vector, J vectors a lane;
//     512 tokens for bf16 x, as many as one adapter has in the
//     multi-adapter step), loaded once; longer runs take several tiles,
//     and each tile after the first adds to the sum the first one wrote,
//     in order;
//   - the x row of each entry is read in 16-byte vectors (8 bf16 or 4 f32
//     tokens a lane), and kEntries entries' loads are all issued before the
//     first multiply-add, so each lane has kEntries * J loads in flight;
//   - the row indices of 32 entries come in one coalesced load, handed out
//     by shuffles;
//   - the kEntries partial sums are reduced together: each butterfly step
//     halves the entries a lane holds, then the rest is a plain butterfly
//     (6 shuffles for 4 entries, not 20), in a fixed order.
// A vector needs every adapter's first token and both row strides to be a
// multiple of V, which the wrapper checks (S % V == 0); any other S, stride
// or address takes the V = 1 instance of the same template (one token a
// lane), which the wrapper counts apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;      // output columns per block
constexpr int kEntries = 4;    // entries whose x loads are in flight at once

// Vectors a lane of V tokens each: a tile of 32 * V * J tokens of a
// column's dy stays in registers (512 for bf16 x, 256 for f32 x, 128 for
// the one-token instance), so that kEntries * J loads fit with no spill.
template <int V>
constexpr int kJ = V == 1 ? 4 : 2;

// V consecutive elements of an x row as loaded, read back as f32 (exact).
template <typename XT, int V>
struct Raw;

template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float at(int i) const {
    const unsigned int w = i < 2 ? r.x : i < 4 ? r.y : i < 6 ? r.z : r.w;
    return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
  }
};

template <>
struct Raw<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_float4(0, 0, 0, 0); }
  __device__ __forceinline__ float at(int i) const {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
  }
};

template <>
struct Raw<__nv_bfloat16, 1> {
  unsigned short r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void zero() { r = 0; }
  __device__ __forceinline__ float at(int) const {
    return __uint_as_float(static_cast<unsigned int>(r) << 16);
  }
};

template <>
struct Raw<float, 1> {
  float r;
  __device__ __forceinline__ void load(const float* p) { r = __ldg(p); }
  __device__ __forceinline__ void zero() { r = 0.f; }
  __device__ __forceinline__ float at(int) const { return r; }
};

// V consecutive f32 of dy, read once (streaming).
template <int V>
__device__ __forceinline__ void load_dy(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __ldcs(p);
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 x = __ldcs(reinterpret_cast<const float4*>(p) + q);
      f[4 * q] = x.x, f[4 * q + 1] = x.y, f[4 * q + 2] = x.z,
      f[4 * q + 3] = x.w;
    }
  }
}

// One butterfly step per halving of the H entries a lane holds: the lanes
// with bit `off` set keep the upper half, the others the lower, each adding
// its partner's copy of the half it keeps. ent gathers which entry p[0]
// is.
template <int H, int E>
__device__ __forceinline__ void fold(float (&p)[E], int lane, int off,
                                     int& ent) {
  if constexpr (H >= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float keep = up ? p[i + H] : p[i];
      const float send = up ? p[i] : p[i + H];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    if (up) ent += H;
    fold<H / 2, E>(p, lane, off >> 1, ent);
  }
}

// The warp-wide sums of E per-lane partials: lane l ends with the sum of
// entry `ent`, the same in the 32 / E lanes of its group.
template <int E>
__device__ __forceinline__ float reduce_entries(float (&p)[E], int lane,
                                                int& ent) {
  ent = 0;
  fold<E / 2, E>(p, lane, 16, ent);
#pragma unroll
  for (int off = 16 / E; off > 0; off >>= 1)
    p[0] += __shfl_xor_sync(0xffffffffu, p[0], off);
  return p[0];
}

template <typename XT, int V>
__global__ void __launch_bounds__(kWarps * 32)
sidedelta_dvals_kernel(const XT* __restrict__ xT, long long ldx,
                       const float* __restrict__ dyT, long long ldy,
                       const int* __restrict__ rows,
                       const int* __restrict__ colptr,
                       const int* __restrict__ rptr,
                       float* __restrict__ dvals, int m, int S, long long K) {
  constexpr int J = kJ<V>;
  constexpr int kTile = 32 * V * J;       // tokens a tile
  static_assert(32 % kEntries == 0, "entry groups divide a warp");
  const int a = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= m) return;  // uniform per warp: the shuffles below stay full
  const long long t0 = static_cast<long long>(rptr[a]) * S;
  const long long t1 = static_cast<long long>(rptr[a + 1]) * S;
  const int* cp = colptr + static_cast<long long>(a) * (m + 1);
  const int k0 = cp[c];
  const int k1 = cp[c + 1];
  if (t0 >= t1 || k0 >= k1) return;  // dvals arrives zero-filled
  const float* dyc = dyT + static_cast<long long>(c) * ldy;
  const int* ra = rows + static_cast<long long>(a) * K;
  float* out = dvals + static_cast<long long>(a) * K;
  for (long long tile = t0; tile < t1; tile += kTile) {
    // this lane's tokens: tile + j * 32 * V + lane * V + i, i < V
    float dy[J][V];
    bool in[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const long long t = tile + j * 32 * V + lane * V;
      in[j] = t < t1;   // whole vectors: t0, t1 and kTile are multiples of V
      if (in[j]) {
        load_dy<V>(dyc + t, dy[j]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) dy[j][i] = 0.f;
      }
    }
    const XT* xl = xT + tile + lane * V;
    for (int kb = k0; kb < k1; kb += 32) {
      const int nb = min(32, k1 - kb);
      const int mine = lane < nb ? __ldg(ra + kb + lane) : 0;
      for (int g = 0; g < nb; g += kEntries) {
        Raw<XT, V> xv[kEntries][J];
#pragma unroll
        for (int e = 0; e < kEntries; ++e) {
          const int row = __shfl_sync(0xffffffffu, mine, g + e);
          const XT* xr = xl + static_cast<long long>(row) * ldx;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            if (g + e < nb && in[j]) xv[e][j].load(xr + j * 32 * V);
            else xv[e][j].zero();
          }
        }
        float acc[kEntries];
#pragma unroll
        for (int e = 0; e < kEntries; ++e) {
          acc[e] = 0.f;
#pragma unroll
          for (int j = 0; j < J; ++j) {
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[e] = fmaf(xv[e][j].at(i), dy[j][i], acc[e]);
          }
        }
        int ent;
        const float sum = reduce_entries<kEntries>(acc, lane, ent);
        if (lane % (32 / kEntries) == 0 && g + ent < nb) {
          float* o = out + kb + g + ent;
          *o = tile == t0 ? sum : *o + sum;
        }
      }
    }
  }
}

template <typename XT, int V>
int run(const void* xT, long long ldx, const float* dyT, long long ldy,
        const int* rows, const int* colptr, const int* rptr, float* dvals,
        int A, int m, int S, long long K, cudaStream_t stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, A);
  sidedelta_dvals_kernel<XT, V><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const XT*>(xT), ldx, dyT, ldy, rows, colptr, rptr, dvals,
      m, S, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xT (n, T) f32 or bf16 with row stride ldx, and dyT (m, T) f32 with row
// stride ldy, tokens grouped by adapter; rows (A, K) int32 and colptr
// (A, m + 1) int32, the column-sorted table; rptr (A + 1) int32, adapter
// a's requests are [rptr[a], rptr[a + 1]) of the grouped order, each S
// tokens; dvals (A, K) f32, zero-filled by the caller. vec: 8 (bf16 x) or 4
// (f32 x) when S, ldx, ldy and both pointers allow 16-byte vectors, else 1.
// Returns cudaGetLastError() after the launch.
extern "C" int sidedelta_dvals_launch(const void* xT, int x_bf16,
                                      long long ldx, const float* dyT,
                                      long long ldy, const int* rows,
                                      const int* colptr, const int* rptr,
                                      float* dvals, int A, int m, int S,
                                      long long K, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && vec == 8)
    return run<__nv_bfloat16, 8>(xT, ldx, dyT, ldy, rows, colptr, rptr,
                                 dvals, A, m, S, K, st);
  if (!x_bf16 && vec == 4)
    return run<float, 4>(xT, ldx, dyT, ldy, rows, colptr, rptr, dvals, A, m,
                         S, K, st);
  if (vec == 1)
    return x_bf16 ? run<__nv_bfloat16, 1>(xT, ldx, dyT, ldy, rows, colptr,
                                          rptr, dvals, A, m, S, K, st)
                  : run<float, 1>(xT, ldx, dyT, ldy, rows, colptr, rptr,
                                  dvals, A, m, S, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
