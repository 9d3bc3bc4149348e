// scatter_apply: the rapid switch, W <- W + alpha * scatter(vals), in place.
//
// Replaces the TPU kernel src/repro/kernels/scatter_apply.py:
// scatter_apply_tiles (Pallas body _scatter_kernel), which bucketed the
// updates by VMEM tile and looped over each bucket with scalar stores.
//
// It takes an AdapterPack's entries as they are: (nl, k) int32 flat indices
// into each of the nl stacked (n, m) matrices of W (layer stride n * m) and
// their (nl, k) f32 values. Each entry reads W at layer * n * m + idx, adds
// alpha * val in f32 and stores the sum (the rounding of
// repro.kernels.ref.scatter_apply_ref: the product and the sum are each
// rounded, never fused, so results equal the reference's bit for bit). A
// pack's indices are unique within each matrix (masks are drawn without
// replacement, fuse_packs merges duplicates); its only repeats are padding
// entries at index 0 with value 0, and an entry of value 0 is skipped, so no
// two threads write one element and no atomics are needed. An index outside
// the matrix is skipped. Any order of the indices gives the same result.
//
// What bounds it on the H100: bytes. It reads the index and value of every
// entry once, and reads and writes each 32-byte sector of W that holds an
// entry; the rest of W is never touched, which is the point of the paper's
// switch. At sparsity 0.98 about 15% of W's sectors hold an entry, so the
// sectors are ~88% of the bytes (chip_smoke.py counts them from the
// indices). On the card the two directions differ: the reads of those
// sectors alone run near the memory's rate, but the dirty sectors go back
// to memory at a fraction of it, as L2 evicts them, and that write-back
// sets the time (tools/kernel_compare.py times both halves apart).
//
// What the design does about it, measured against the alternatives
// (PERF.md): more misses in flight make it slower, not faster (whether
// through the memory's row misses or L2's eviction order is not known), so
// it keeps one entry a thread, in the order of the entries:
//   - a flat grid over the nl * k entries, one entry a thread, blocks
//     dispatched in order, so the entries in flight are one short run of
//     the sorted entries (every mask and fuse_packs emit ascending indices)
//     and their sectors lie in one short span of W; each entry finds its
//     layer from its flat position, so there is no layer limit;
//   - blocks of kThreads, and kBlocksPerSm of them an SM at most (16 warps,
//     a quarter of what fits), held there by reserving shared memory the
//     kernel does not use: the fewest warps that still keep the memory
//     busy, found by a sweep of block sizes and counts;
//   - W is read through L2 only (nothing in L1 is reused), and the store
//     is left to L2, which writes the dirty sector back.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
scatter_apply_kernel(float* __restrict__ w, const int* __restrict__ idx,
                     const float* __restrict__ vals, long long n,
                     long long k, long long nm, float alpha) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const int i = __ldg(idx + e);
  const float v = __ldg(vals + e);
  if (v == 0.0f || i < 0 || i >= nm) return;
  float* p = w + e / k * nm + i;
  *p = __fadd_rn(__ldcg(p), __fmul_rn(alpha, v));
}

// The shared memory a block reserves so that at most kBlocksPerSm blocks
// fit on an SM (read once a device; the attribute is set with it).
int reserved_smem() {
  static int cached[kMaxDevices];   // bytes + 1 per device, 0 = not read yet
  int dev = 0;
  cudaGetDevice(&dev);
  int& bytes = cached[dev < kMaxDevices ? dev : 0];
  if (bytes == 0) {
    int per_sm = 0, per_block = 0;
    cudaDeviceGetAttribute(&per_sm,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&per_block,
                           cudaDevAttrReservedSharedMemoryPerBlock, dev);
    const int s = per_sm / kBlocksPerSm - per_block > 0
                      ? per_sm / kBlocksPerSm - per_block
                      : 0;
    cudaFuncSetAttribute(scatter_apply_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, s);
    bytes = s + 1;
  }
  return bytes - 1;
}

}  // namespace

// w: f32, nl stacked (n, m) matrices, updated in place; idx (nl, k) int32
// flat indices into each matrix, unique apart from value-0 entries; vals
// (nl, k) f32. nm = n * m. Returns cudaGetLastError().
extern "C" int scatter_apply_launch(float* w, const int* idx,
                                    const float* vals, long long nl,
                                    long long k, long long nm, float alpha,
                                    void* stream) {
  const long long n = nl * k;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  scatter_apply_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                         reserved_smem(),
                         static_cast<cudaStream_t>(stream)>>>(
      w, idx, vals, n, k, nm, alpha);
  return static_cast<int>(cudaGetLastError());
}
