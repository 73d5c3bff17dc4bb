// Beam-reorder row gather for Hopper (sm_90a), plain C interface.
//
// Replaces both TPU kernels of moonshine_tpu/ops/beam_gather.py:
// `_gather_kernel` behind `gather_kv_rows` (the self-KV caches K and V,
// [L, N, H, hd, S] in float32, bf16 or int8) and `_gather_scale_kernel`
// behind `gather_scale_rows` (the int8-KV scale arrays, [L, N, H, S]
// float32).  Both copy whole rows along axis 1 of two arrays that share one
// index vector:
//
//   dst0[l, n] = src0[l, idx[n]]      dst1[l, n] = src1[l, idx[n]]
//
// so one kernel serves both: a row is `row_bytes` contiguous bytes
// (H*hd*S*itemsize for the caches, H*S*4 for the scales), and the row of
// (l, n) starts at byte (l*N + n) * row_bytes.
//
// What bounds it.  Each call reads every source row it needs and writes
// every destination row once: 4*L*N*row_bytes bytes for the two arrays and
// no arithmetic, so the memory rate is the bound.  At the bench's beam
// shape (Base, 128 utterances x beam 4: L=8, N=512, H=8, hd=52, S=61) that
// is 415.8 MB in int8, 0.124 ms at 3.35 TB/s; the scales move 32.0 MB.
//
// What the design does about it.  The TPU kernel gives each destination
// row one grid step and scalar-prefetches the source index; here each
// block takes one (l, n) destination row and loads its own idx[n] (Hopper
// has no scalar prefetch, and one 4-byte load per 25 KB row costs
// nothing).  The block copies the K row and the V row together, so two
// independent loads are in flight per thread per iteration.  Threads move
// 16-byte words, neighbouring threads on neighbouring addresses, whenever
// row_bytes and the four base pointers are 16-byte aligned (every Base
// shape is); otherwise the widest word that divides them all (8, 4, 2 or
// 1 bytes).  An index outside [0, N) traps: the kernel never reads out of
// bounds, and a bad parent vector fails loudly instead of copying garbage.
// The outputs are fresh buffers that never alias the inputs, so any
// permutation (duplicates, dropped rows) is safe.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kMaxThreads)
gather_rows(const W* __restrict__ src0, const W* __restrict__ src1, W* __restrict__ dst0,
            W* __restrict__ dst1, const int32_t* __restrict__ idx, int rows,
            long long row_words) {
  const int n = blockIdx.x;
  const long long l = blockIdx.y;
  const int src = idx[n];
  if (src < 0 || src >= rows) __trap();
  const long long from = (l * rows + src) * row_words;
  const long long to = (l * rows + n) * row_words;
  for (long long i = threadIdx.x; i < row_words; i += blockDim.x) {
    const W a = src0[from + i];
    const W b = src1[from + i];
    dst0[to + i] = a;
    dst1[to + i] = b;
  }
}

template <typename W>
cudaError_t launch(const void* src0, const void* src1, void* dst0, void* dst1,
                   const int32_t* idx, int layers, int rows, long long row_bytes,
                   cudaStream_t stream) {
  const long long row_words = row_bytes / static_cast<long long>(sizeof(W));
  // Enough warps to cover a row in one pass where it is short (a scale row
  // is 122 words of 16 bytes at Base), at most kMaxThreads.
  const long long want = (row_words + 31) / 32 * 32;
  const int threads = static_cast<int>(want < kMaxThreads ? want : kMaxThreads);
  const dim3 grid(rows, layers);
  gather_rows<W><<<grid, threads, 0, stream>>>(
      static_cast<const W*>(src0), static_cast<const W*>(src1), static_cast<W*>(dst0),
      static_cast<W*>(dst1), idx, rows, row_words);
  return cudaGetLastError();
}

}  // namespace

// src0/src1 and dst0/dst1: [layers, rows, row_bytes] byte arrays; idx: rows
// int32 source rows.  Returns the CUDA error of the launch (0 on success);
// never synchronises.
extern "C" int beam_gather_rows(const void* src0, const void* src1, void* dst0, void* dst1,
                                const void* idx, int layers, int rows, long long row_bytes,
                                void* stream) {
  if (layers <= 0 || rows <= 0 || row_bytes <= 0 || layers > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src0) | reinterpret_cast<uintptr_t>(src1) |
                         reinterpret_cast<uintptr_t>(dst0) | reinterpret_cast<uintptr_t>(dst1) |
                         static_cast<uintptr_t>(row_bytes);
  cudaError_t err;
  if (bits % 16 == 0) {
    err = launch<uint4>(src0, src1, dst0, dst1, ix, layers, rows, row_bytes, s);
  } else if (bits % 8 == 0) {
    err = launch<uint2>(src0, src1, dst0, dst1, ix, layers, rows, row_bytes, s);
  } else if (bits % 4 == 0) {
    err = launch<uint32_t>(src0, src1, dst0, dst1, ix, layers, rows, row_bytes, s);
  } else if (bits % 2 == 0) {
    err = launch<uint16_t>(src0, src1, dst0, dst1, ix, layers, rows, row_bytes, s);
  } else {
    err = launch<uint8_t>(src0, src1, dst0, dst1, ix, layers, rows, row_bytes, s);
  }
  return static_cast<int>(err);
}
