// Quantize-and-write of a decoder layer's new keys and values into its int8
// KV caches, for Hopper (sm_90a), plain C interface: K7.
//
// Replaces no TPU kernel.  The JAX package's decoders quantize new K/V with
// `quantize_kv` of moonshine_tpu/ops/int8_kv.py and store them with
// `dynamic_update_slice`, plain JAX that XLA fuses.  The port ran the same
// chain eagerly in `write_kv`'s int8 branch (ops/int8_kv.py): eleven
// launches for each of K and V (the float copy, abs, amax, > 0, the scale's
// division, ones_like, where, the values' division, round, clamp, the int8
// cast), then four writes, each one launch at a host cursor and five at
// per-row starts: 26 to 42 launches a layer a decoder call.  This kernel
// does all of it, for K and V of one layer, in one launch.  Per key column x
// (hd values) of K or V, the plain version's arithmetic on the card:
//
//   amax  = max_d |x_d|                                  float32, exact
//   scale = amax > 0 ? amax * fl(1/127) : 1              float32
//   q_d   = clamp(rint(x_d / scale), -127, 127)          IEEE division,
//                                                        half to even
//
// PyTorch computes `amax / 127.0` on a CUDA tensor as the product with the
// scalar's reciprocal rounded to float32 (its CPU kernel divides), so the
// scale is that product here; `x / scale` of two tensors is an IEEE
// division there and here (__fdiv_rn).  q goes to the int8 cache and the
// scale to the scale cache at the caller's columns: a host cursor (one start
// for every row), or per-row starts read in place as int32 or int64 and
// clamped to [0, T - s] as XLA clamps a dynamic update slice's start.  The
// values and scales equal the plain chain's bit for bit.  (NaN inputs are
// not held to it: fmaxf drops a NaN where the plain amax keeps it.)
//
// What bounds it.  Bytes: each new value read once (2 bytes in bf16), each
// int8 value and each float32 scale written once.  At a decode step's shape
// that is under 800 KB (Base b64 at s=1: 64 rows x 8 heads x 52 dims, K and
// V, 164 KB; the service 138 KB; Canary at B=128: 795 KB), 0.04-0.24 us at
// 3.35 TB/s: the kernel is bound by the latency of one launch and of its
// trips to memory.  At the service's verify (s = 129) and its ingest of 128
// cross columns it moves 17.7-17.8 MB, 5.3 us of bytes.
//
// What the design does.  One launch covers K and V of the layer.  A block
// owns a tile of up to kTileCols new columns of one (tensor, row, head); a
// warp quantizes one column at a time: its lanes read the column's hd
// values (hd has unit stride in the callers' permuted views, so a warp's
// loads are one or two 128-byte lines), hold them in registers, reduce amax
// by shuffles, then quantize into a shared-memory tile laid out dim-major.
// After one barrier the block writes each dim row's run of the tile's int8
// columns contiguously (the caches are dim-major [.., hd, T]: at s >= 32 a
// warp stores one 32-byte run a dim, where column by column it would store
// one byte a dim at stride T) and the tile's scales as one run.  The warps
// of a block, min(s, kMaxWarps), and the tiles follow from s alone; at s = 1
// a block is one warp and one column, and the grid (2 x B x H blocks: 1,024
// for Base b64, 704 for the service, 2,048 for Canary) is resident on the
// card at once.  Every pointer is read through the strides it is handed; the
// caches' and scales' columns must be contiguous.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 32;               // new columns a block quantizes and stores
constexpr int kTileStride = kTileCols + 4;  // bytes between the tile's dim rows: lane d's
                                            // byte stores land in 32 distinct banks
constexpr int kMaxHeadDim = 256;            // ops/int8_kv.py's MAX_WRITE_HEAD_DIM
constexpr int kPerLane = kMaxHeadDim / 32;  // a column's values a lane holds
constexpr int kMaxWarps = 8;
constexpr float kInv127 = 1.0f / 127.0f;  // rounded to float32 once, as PyTorch rounds it

struct Params {
  const void* src[2];  // new K and V [B, H, hd, s]
  int8_t* q[2];        // int8 caches [B, H, hd, T], T stride 1
  float* scale[2];     // scales [B, H, T], T stride 1
  const void* starts;  // per-row starts [B], int32 or int64; null: the host cursor
  long long src_stride[2][4];
  long long q_stride[2][3];
  long long scale_stride[2][2];
  long long starts_stride;
  long long cursor;
  long long cols;  // T
  int batch, heads, hd, s, tiles;
  int starts_int64;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32) kv_write_kernel(const Params p) {
  __shared__ int8_t tile[kMaxHeadDim * kTileStride];
  __shared__ float tile_scale[kTileCols];
  long long block = blockIdx.x;
  const int t = static_cast<int>(block % p.tiles);
  block /= p.tiles;
  const int h = static_cast<int>(block % p.heads);
  block /= p.heads;
  const int b = static_cast<int>(block % p.batch);
  const int which = static_cast<int>(block / p.batch);  // 0: K, 1: V
  const int j0 = t * kTileCols;
  const int n = min(kTileCols, p.s - j0);  // the tile's columns

  const long long* ss = p.src_stride[which];
  const T* src = static_cast<const T*>(p.src[which]) + b * ss[0] + h * ss[1] + j0 * ss[3];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int c = threadIdx.x >> 5; c < n; c += warps) {
    const T* col = src + c * ss[3];
    float x[kPerLane];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = i * 32 + lane;
      x[i] = d < p.hd ? widen(col[d * ss[2]]) : 0.f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = i * 32 + lane;
      if (d < p.hd) tile[d * kTileStride + c] = quantize(x[i], scale);
    }
    if (lane == 0) tile_scale[c] = scale;
  }
  __syncthreads();

  long long start = p.cursor;
  if (p.starts != nullptr) {
    const long long i = b * p.starts_stride;
    start = p.starts_int64 ? static_cast<const long long*>(p.starts)[i]
                           : static_cast<long long>(static_cast<const int*>(p.starts)[i]);
    start = min(max(start, 0LL), p.cols - p.s);
  }
  start += j0;
  const long long* qs = p.q_stride[which];
  int8_t* q = p.q[which] + b * qs[0] + h * qs[1] + start;
  for (int i = threadIdx.x; i < p.hd * n; i += blockDim.x) {
    const int d = i / n;
    const int c = i - d * n;
    q[d * qs[2] + c] = tile[d * kTileStride + c];
  }
  if (threadIdx.x < n) {
    const long long* sc = p.scale_stride[which];
    p.scale[which][b * sc[0] + h * sc[1] + start + threadIdx.x] = tile_scale[threadIdx.x];
  }
}

}  // namespace

// k_new, v_new [B, H, hd, s] in the dtype coded by `dtype` (0 float32, 1 bf16,
// 2 fp16), read through their element strides (strides[0:4], strides[4:8]);
// k_q, v_q [B, H, hd, T] int8 (strides[8:11], strides[11:14] for B, H, hd;
// T stride 1); k_s, v_s [B, H, T] float32 (strides[14:16], strides[16:18];
// T stride 1).  shape = (B, H, hd, s, T).  The columns: starts_dtype 0 takes
// [cursor, cursor + s) of every row (0 <= cursor <= T - s); 1 (int32) and 2
// (int64) read row b's start at starts[b * strides[18]], clamped to
// [0, T - s].  Returns the CUDA error of the launch (0 on success); never
// synchronises.
extern "C" int kv_write(const void* k_new, const void* v_new, void* k_q, void* v_q, void* k_s,
                        void* v_s, const void* starts, const long long* shape,
                        const long long* strides, int dtype, int starts_dtype, long long cursor,
                        void* stream) {
  const long long b = shape[0], h = shape[1], hd = shape[2], s = shape[3], t = shape[4];
  if (b <= 0 || h <= 0 || hd <= 0 || hd > kMaxHeadDim || s <= 0 || s > t || b > INT_MAX ||
      h > INT_MAX || s > INT_MAX || dtype < 0 || dtype > 2 || starts_dtype < 0 ||
      starts_dtype > 2 || (starts_dtype == 0 && (cursor < 0 || cursor > t - s)) ||
      (starts_dtype != 0 && starts == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (s + kTileCols - 1) / kTileCols;
  const long long blocks = 2 * b * h * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.src[0] = k_new;
  p.src[1] = v_new;
  p.q[0] = static_cast<int8_t*>(k_q);
  p.q[1] = static_cast<int8_t*>(v_q);
  p.scale[0] = static_cast<float*>(k_s);
  p.scale[1] = static_cast<float*>(v_s);
  p.starts = starts_dtype == 0 ? nullptr : starts;
  for (int i = 0; i < 4; ++i) {
    p.src_stride[0][i] = strides[i];
    p.src_stride[1][i] = strides[4 + i];
  }
  for (int i = 0; i < 3; ++i) {
    p.q_stride[0][i] = strides[8 + i];
    p.q_stride[1][i] = strides[11 + i];
  }
  for (int i = 0; i < 2; ++i) {
    p.scale_stride[0][i] = strides[14 + i];
    p.scale_stride[1][i] = strides[16 + i];
  }
  p.starts_stride = strides[18];
  p.cursor = starts_dtype == 0 ? cursor : 0;
  p.cols = t;
  p.batch = static_cast<int>(b);
  p.heads = static_cast<int>(h);
  p.hd = static_cast<int>(hd);
  p.s = static_cast<int>(s);
  p.tiles = static_cast<int>(tiles);
  p.starts_int64 = starts_dtype == 2;
  const int threads = 32 * static_cast<int>(s < kMaxWarps ? s : kMaxWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (dtype) {
    case 0: kv_write_kernel<float><<<grid, threads, 0, st>>>(p); break;
    case 1: kv_write_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(p); break;
    default: kv_write_kernel<__half><<<grid, threads, 0, st>>>(p); break;
  }
  return static_cast<int>(cudaGetLastError());
}
