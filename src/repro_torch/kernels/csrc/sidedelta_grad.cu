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
// token-minor order, xT (n, T) and dyT (m, T) with T = B * S, so adapter a
// owns the token range [rptr[a] * S, rptr[a + 1] * S). Token-minor rows
// make every gather below a coalesced read of consecutive tokens: in the
// (B, S, n) layout the same values lie n elements apart.
//
// One warp owns one output column c of one adapter (grid x: columns, in
// groups of kWarps a block; grid y: adapters). For each entry k of the
// column, its lanes stride the adapter's tokens, multiplying xT[rows[k], t]
// by dyT[c, t] (the dy column stays in L1 across the column's entries),
// and reduce by shuffles in a fixed order; lane 0 writes dvals[a, k]. Each
// entry has exactly one writer: no atomics, deterministic results.
//
// What bounds it on the H100: operations. 2 * T_a * K f32 multiply-adds
// per adapter (T_a its tokens), outside the tensor cores, against
// K * 4 bytes written and x and dy read once; the gathers of x rows are
// served from L2 (one adapter's xT is n * T_a * 2 bytes: 4.7 MB for
// starcoder2-7b's w_up at T_a = 512).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // output columns per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename XT>
__global__ void __launch_bounds__(kWarps * 32)
sidedelta_dvals_kernel(const XT* __restrict__ xT,
                       const float* __restrict__ dyT,
                       const int* __restrict__ rows,
                       const int* __restrict__ colptr,
                       const int* __restrict__ rptr,
                       float* __restrict__ dvals, int m, int S, long long T,
                       long long K) {
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
  const float* dyc = dyT + static_cast<long long>(c) * T;
  const int* ra = rows + static_cast<long long>(a) * K;
  float* out = dvals + static_cast<long long>(a) * K;
  for (int k = k0; k < k1; ++k) {
    const XT* xr = xT + static_cast<long long>(ra[k]) * T;
    float acc = 0.f;
    for (long long t = t0 + lane; t < t1; t += 32) {
      acc = fmaf(to_f32(xr[t]), dyc[t], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out[k] = acc;
  }
}

}  // namespace

// xT (n, T) f32 or bf16 and dyT (m, T) f32, tokens grouped by adapter;
// rows (A, K) int32 and colptr (A, m + 1) int32, the column-sorted table;
// rptr (A + 1) int32, adapter a's requests are [rptr[a], rptr[a + 1]) of
// the grouped order, each S tokens; dvals (A, K) f32, zero-filled by the
// caller. Returns cudaGetLastError() after the launch.
extern "C" int sidedelta_dvals_launch(const void* xT, int x_bf16,
                                      const float* dyT, const int* rows,
                                      const int* colptr, const int* rptr,
                                      float* dvals, int A, int m, int S,
                                      long long T, long long K,
                                      void* stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, A);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    sidedelta_dvals_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(xT), dyT, rows, colptr, rptr, dvals,
        m, S, T, K);
  } else {
    sidedelta_dvals_kernel<float><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const float*>(xT), dyT, rows, colptr, rptr, dvals, m, S,
        T, K);
  }
  return static_cast<int>(cudaGetLastError());
}
