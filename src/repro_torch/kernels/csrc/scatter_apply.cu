// scatter_apply: the rapid switch, W <- W + alpha * scatter(vals), in place.
//
// Replaces the TPU kernel src/repro/kernels/scatter_apply.py:
// scatter_apply_tiles (Pallas body _scatter_kernel), which bucketed the
// updates by VMEM tile and looped over each bucket with scalar stores.
//
// It takes an AdapterPack's entries as they are: (nl, k) int32 flat indices
// into each of the nl stacked (n, m) matrices of W (layer stride n * m) and
// their (nl, k) f32 values. Grid y walks the matrices, grid x the entries
// of one; one thread owns one entry: it reads W at
// layer * n * m + idx, adds alpha * val in f32 and stores the sum (the
// rounding of repro.kernels.ref.scatter_apply_ref: the product and the sum
// are each rounded, never fused, so results equal the reference's bit for
// bit). A pack's indices are unique within each matrix (masks are drawn
// without replacement, fuse_packs merges duplicates); its only repeats are
// padding entries at index 0 with value 0, and an entry of value 0 is
// skipped, so no two threads write one element and no atomics are needed.
// An index outside the matrix is skipped.
//
// What bounds it on the H100: bytes. It reads the index and value of every
// entry once and reads and writes one W element for each; the rest of W is
// never touched, which is the point of the paper's switch. Each W access
// moves a 32-byte sector for 4 useful bytes, and in random order it also
// misses DRAM's open rows, so the port's packs keep each matrix's indices
// ascending (rand masks are sorted when drawn, fuse_packs emits them
// sorted): consecutive blocks then walk W in memory order.

#include <cuda_runtime.h>

namespace {

__global__ void scatter_apply_kernel(float* __restrict__ w,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ vals,
                                     long long k, long long nm,
                                     float alpha) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= k) return;
  const long long t = blockIdx.y * k + e;
  const float v = vals[t];
  const int i = idx[t];
  if (v == 0.0f || i < 0 || i >= nm) return;
  float* wl = w + blockIdx.y * nm;
  wl[i] = __fadd_rn(wl[i], __fmul_rn(alpha, v));
}

}  // namespace

// w: f32, nl stacked (n, m) matrices, updated in place; idx (nl, k) int32
// flat indices into each matrix, unique apart from value-0 entries; vals
// (nl, k) f32. nm = n * m. Returns cudaGetLastError().
extern "C" int scatter_apply_launch(float* w, const int* idx,
                                    const float* vals, long long nl,
                                    long long k, long long nm, float alpha,
                                    void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid(static_cast<unsigned int>((k + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(nl));
  scatter_apply_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      w, idx, vals, k, nm, alpha);
  return static_cast<int>(cudaGetLastError());
}
