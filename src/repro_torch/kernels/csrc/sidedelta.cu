// sidedelta: per-request sparse side delta of multi-tenant SHiRA serving.
//
// Replaces the TPU kernel src/repro/kernels/sidedelta.py:sidedelta_rows
// (Pallas body _sidedelta_kernel). For request b with adapter a = ids[b]:
//
//   out[b, s, c] = sum over entries k of adapter a in column c of
//                  x[b, s, rows[a, k]] * vals[a, k] * scale[a]
//
// and out[b] = 0 when ids[b] < 0. out is f32; the caller adds it to x @ W.
//
// Layout (built once per adapter at registration by
// repro_torch.kernels.ops.sidedelta_table): each adapter's entries are
// sorted by column, then row, with duplicate coordinates summed; colptr
// (A, m + 1) holds each column's first entry, and colptr[a, m] is the
// adapter's valid count. Entries past it are padding and are never read, so
// a padded table costs what an unpadded one does.
//
// What bounds it on the H100: bytes. Each request streams its adapter's
// row indices and values (2-4 + 1-4 bytes an entry, K ~ 2% of n*m) and
// does S multiply-adds per entry, far below the card's compute rate. The
// design reads the table once per (request, group of SC rows) with
// coalesced loads: one warp owns one output column and its 32 lanes stride
// through that column's entries. x is gathered at random rows from L1/L2
// (one activation row is at most 74 KB). Lanes reduce with shuffles in a
// fixed order, so there are no atomics and results are deterministic.
// Neighbouring blocks are requests on the same columns, so requests that
// share an adapter read its table lines while they are in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // output columns per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <int SC, typename XT, typename IT, typename VT>
__global__ void __launch_bounds__(kWarps * 32)
sidedelta_kernel(const XT* __restrict__ x, const IT* __restrict__ rows,
                 const VT* __restrict__ vals, const int* __restrict__ colptr,
                 const float* __restrict__ scale, const int* __restrict__ ids,
                 float* __restrict__ out, int S, int n, int m, int A,
                 long long K) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (c >= m) return;  // uniform per warp: the shuffles below stay full
  const int s0 = blockIdx.z * SC;
  const int ns = min(SC, S - s0);
  const int a = ids[b];

  float acc[SC];
#pragma unroll
  for (int s = 0; s < SC; ++s) acc[s] = 0.f;

  if (a >= 0 && a < A) {
    const int* cp = colptr + static_cast<long long>(a) * (m + 1);
    const int k0 = cp[c];
    const int k1 = cp[c + 1];
    const IT* ra = rows + static_cast<long long>(a) * K;
    const VT* va = vals + static_cast<long long>(a) * K;
    const float sc = scale != nullptr ? scale[a] : 1.f;
    const XT* xb = x + (static_cast<long long>(b) * S + s0) * n;
    for (int k = k0 + lane; k < k1; k += 32) {
      const int r = static_cast<int>(ra[k]);
      const float v = to_f32(va[k]) * sc;
#pragma unroll
      for (int s = 0; s < SC; ++s) {
        if (s < ns) {
          acc[s] = fmaf(to_f32(xb[static_cast<long long>(s) * n + r]), v,
                        acc[s]);
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < SC; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
    }
  }
  float* ob = out + (static_cast<long long>(b) * S + s0) * m + c;
#pragma unroll
  for (int s = 0; s < SC; ++s) {
    if (lane == s && s < ns) ob[static_cast<long long>(s) * m] = acc[s];
  }
}

struct Args {
  const void* x;
  const void* rows;
  const void* vals;
  const int* colptr;
  const float* scale;
  const int* ids;
  float* out;
  int B, S, n, m, A;
  long long K;
  cudaStream_t stream;
};

template <int SC, typename XT, typename IT, typename VT>
int run(const Args& g) {
  const dim3 grid(g.B, (g.m + kWarps - 1) / kWarps, (g.S + SC - 1) / SC);
  sidedelta_kernel<SC, XT, IT, VT><<<grid, kWarps * 32, 0, g.stream>>>(
      static_cast<const XT*>(g.x), static_cast<const IT*>(g.rows),
      static_cast<const VT*>(g.vals), g.colptr, g.scale, g.ids, g.out, g.S,
      g.n, g.m, g.A, g.K);
  return static_cast<int>(cudaGetLastError());
}

template <int SC, typename XT, typename IT>
int by_vals(const Args& g, int vals_int8) {
  return vals_int8 ? run<SC, XT, IT, int8_t>(g) : run<SC, XT, IT, float>(g);
}

template <int SC, typename XT>
int by_rows(const Args& g, int rows_int16, int vals_int8) {
  return rows_int16 ? by_vals<SC, XT, int16_t>(g, vals_int8)
                    : by_vals<SC, XT, int32_t>(g, vals_int8);
}

template <int SC>
int by_x(const Args& g, int x_bf16, int rows_int16, int vals_int8) {
  return x_bf16 ? by_rows<SC, __nv_bfloat16>(g, rows_int16, vals_int8)
                : by_rows<SC, float>(g, rows_int16, vals_int8);
}

}  // namespace

// x (B, S, n) f32 or bf16; rows (A, K) int32 or int16; vals (A, K) f32 or
// int8; colptr (A, m + 1) int32; scale (A,) f32 or null; ids (B,) int32;
// out (B, S, m) f32. Returns cudaGetLastError() after the launch.
extern "C" int sidedelta_launch(const void* x, int x_bf16, const void* rows,
                                int rows_int16, const void* vals,
                                int vals_int8, const int* colptr,
                                const float* scale, const int* ids,
                                float* out, int B, int S, int n, int m, int A,
                                long long K, void* stream) {
  const Args g{x, rows, vals, colptr, scale, ids, out, B, S, n, m, A, K,
               static_cast<cudaStream_t>(stream)};
  // decode steps (S == 1) keep one accumulator; prefill walks the table
  // once per group of 8 rows
  return S == 1 ? by_x<1>(g, x_bf16, rows_int16, vals_int8)
                : by_x<8>(g, x_bf16, rows_int16, vals_int8);
}
