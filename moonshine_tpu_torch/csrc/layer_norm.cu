// LayerNorm over the last axis with float32 statistics, for Hopper (sm_90a),
// plain C interface: K6.
//
// Replaces no TPU kernel.  `layer_norm` of moonshine_tpu/models/layers.py is
// plain JAX, which XLA fuses into one pass; its PyTorch counterpart, run
// eagerly, took eleven launches a call (x.float(), mean, subtract, square,
// mean, + eps, rsqrt, subtract, multiply, multiply by the weight, the cast
// back), and the Moonshine decoders call it three times a layer a decoder
// call.  This kernel computes the whole function in one launch.  Per row x of
// width D (ops/layer_norm.py's plain version, rounding place by rounding
// place):
//
//   mean = (sum_i x_i) / D                          float32
//   var  = (sum_i (x_i - mean)^2) / D               float32, the deviations
//                                                   squared, not E[x^2] - mean^2
//   y_i  = io(((x_i - mean) * rsqrtf(var + eps)) * w_i (+ b_i))
//
// x and y are float32, bf16 or fp16; w and b float32, bf16 or fp16, widened
// to float32; io rounds once, to x's dtype.  Products and sums are taken one
// rounding each (__fmul_rn, __fadd_rn: no contraction into an FMA), as the
// plain version's separate operations round; only the order of the float32
// sums differs from it.
//
// What bounds it.  Bytes: x read once, y written once, w and b read once a
// block (from L2 after the first).  At an encoder's shape (64 x 256 rows of
// 416 in bf16) that is 27.3 MB, 8.1 us at 3.35 TB/s.  At a decode step's
// shape (64 or 32 rows) it is under 100 KB: there the kernel is bound by
// the latency of one launch and of its one trip to memory, not by bytes.
//
// What the design does.  It reads x once and writes y once; the row stays on
// chip between the two.  Up to D = 1024 one warp owns a row, held in
// registers (13 values a lane at 416, 22 at 704): 16-byte loads where D, the
// row stride and every pointer allow (8 values a load in bf16, 4 in float32),
// one value a load otherwise; the weight and bias are loaded beside x, before
// the reductions, so their trips overlap; two warp-shuffle sums, first of x,
// then of the squared deviations; four rows a block.  Above 1024, one block of
// 256 threads owns a row, kept as float32 in shared memory, with the same two
// sums as block reductions.  The widest row is what one block's shared memory
// holds (kMaxWidth).  The parameters follow from the shape and the alignment
// alone, and every row of a call sums in the same order, wherever it lies in
// the grid.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarpMaxWidth = 1024;  // rows up to this width: a warp a row, in registers
constexpr int kRowsPerBlock = 4;     // warps (rows) in a block of the warp kernel
constexpr int kBlockThreads = 256;   // threads of the block kernel (one row a block)
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemLimit = 232448;  // shared memory one Hopper block may opt into
constexpr long long kMaxWidth = static_cast<long long>((kSmemLimit - 1024) / sizeof(float));

struct Params {
  const void* x;
  const void* w;
  const void* b;  // null: no bias
  void* y;        // [rows, width], contiguous
  long long rows;
  long long x_stride;  // elements between rows of x; its last axis has stride 1
  int width;
  float eps;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) { return __float2half_rn(v); }

// N values of T loaded or stored at once: 16 bytes for x and y on the
// vector path, one value on the scalar one.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* base, long long i) {
  return reinterpret_cast<const Pack<T, N>*>(base)[i];
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// y = ((x - mean) * rs) * w (+ b), one rounding a step, in T.
template <typename T, typename W, int N>
__device__ __forceinline__ Pack<T, N> normalise(const float (&d)[N], float rs,
                                                const Pack<W, N>& w, const Pack<W, N>& b,
                                                bool has_bias) {
  Pack<T, N> out;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    float v = __fmul_rn(__fmul_rn(d[e], rs), widen(w.v[e]));
    if (has_bias) v = __fadd_rn(v, widen(b.v[e]));
    out.v[e] = narrow<T>(v);
  }
  return out;
}

// One warp a row, the row in registers: lane L holds the packs L, L + 32,
// L + 64, ... of its row (kPacks at most, 32 values).
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_warp_kernel(const Params p) {
  constexpr int kPacks = kWarpMaxWidth / (32 * N);
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // the whole warp leaves together
  const T* x = static_cast<const T*>(p.x) + row * p.x_stride;
  const W* w = static_cast<const W*>(p.w);
  const W* b = static_cast<const W*>(p.b);
  const bool has_bias = b != nullptr;
  const int packs = p.width / N;

  float d[kPacks][N];
  Pack<W, N> wp[kPacks], bp[kPacks];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPacks; ++i) {
    const int j = i * 32 + lane;
    if (j < packs) {
      const Pack<T, N> xp = load<T, N>(x, j);
      wp[i] = load<W, N>(w, j);
      if (has_bias) bp[i] = load<W, N>(b, j);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        d[i][e] = widen(xp.v[e]);
        sum = __fadd_rn(sum, d[i][e]);
      }
    }
  }
  const float width = static_cast<float>(p.width);
  const float mean = __fdiv_rn(warp_sum(sum), width);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kPacks; ++i) {
    if (i * 32 + lane < packs) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        d[i][e] = __fsub_rn(d[i][e], mean);
        sq = __fadd_rn(sq, __fmul_rn(d[i][e], d[i][e]));
      }
    }
  }
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), width), p.eps));
  Pack<T, N>* y = reinterpret_cast<Pack<T, N>*>(static_cast<T*>(p.y) + row * p.width);
#pragma unroll
  for (int i = 0; i < kPacks; ++i) {
    const int j = i * 32 + lane;
    if (j < packs) y[j] = normalise<T, W, N>(d[i], rs, wp[i], bp[i], has_bias);
  }
}

// The sum over the block, the same in every thread: each warp's shuffle sum,
// then every warp adds the warps' sums in the same order.
__device__ __forceinline__ float block_sum(float s, float* partial) {
  constexpr int kWarps = kBlockThreads / 32;
  s = warp_sum(s);
  const int lane = threadIdx.x & 31;
  if (lane == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  s = warp_sum(lane < kWarps ? partial[lane] : 0.f);
  __syncthreads();  // partial is written again by the next sum
  return s;
}

// One block a row, the row as float32 in shared memory (D > kWarpMaxWidth).
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kBlockThreads) layer_norm_block_kernel(const Params p) {
  extern __shared__ float row_values[];
  __shared__ float partial[kBlockThreads / 32];
  const long long row = blockIdx.x;
  const T* x = static_cast<const T*>(p.x) + row * p.x_stride;
  const W* w = static_cast<const W*>(p.w);
  const W* b = static_cast<const W*>(p.b);
  const bool has_bias = b != nullptr;
  const int packs = p.width / N;

  float sum = 0.f;
  for (int j = threadIdx.x; j < packs; j += kBlockThreads) {
    const Pack<T, N> xp = load<T, N>(x, j);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float v = widen(xp.v[e]);
      row_values[j * N + e] = v;
      sum = __fadd_rn(sum, v);
    }
  }
  const float width = static_cast<float>(p.width);
  const float mean = __fdiv_rn(block_sum(sum, partial), width);  // its sync publishes the row
  float sq = 0.f;
  for (int j = threadIdx.x; j < packs; j += kBlockThreads) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float dv = __fsub_rn(row_values[j * N + e], mean);
      sq = __fadd_rn(sq, __fmul_rn(dv, dv));
    }
  }
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(block_sum(sq, partial), width), p.eps));
  Pack<T, N>* y = reinterpret_cast<Pack<T, N>*>(static_cast<T*>(p.y) + row * p.width);
  Pack<W, N> bp{};
  for (int j = threadIdx.x; j < packs; j += kBlockThreads) {
    float dv[N];
#pragma unroll
    for (int e = 0; e < N; ++e) dv[e] = __fsub_rn(row_values[j * N + e], mean);
    if (has_bias) bp = load<W, N>(b, j);
    y[j] = normalise<T, W, N>(dv, rs, load<W, N>(w, j), bp, has_bias);
  }
}

template <typename T, typename W, int N>
cudaError_t launch_block(const Params& p, cudaStream_t stream) {
  auto kernel = layer_norm_block_kernel<T, W, N>;
  const size_t smem = static_cast<size_t>(p.width) * sizeof(float);
  if (smem > kSmemDefault) {
    static uint64_t opted_in = 0;  // a bit per device
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= 64) return cudaErrorInvalidDevice;
    if (!(opted_in >> device & 1)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemLimit - 1024));
      if (err != cudaSuccess) return err;
      opted_in |= uint64_t{1} << device;
    }
  }
  kernel<<<static_cast<unsigned>(p.rows), kBlockThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename W, int N>
cudaError_t launch_width(const Params& p, cudaStream_t stream) {
  if (p.width > kWarpMaxWidth) return launch_block<T, W, N>(p, stream);
  const long long blocks = (p.rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_warp_kernel<T, W, N>
      <<<static_cast<unsigned>(blocks), kRowsPerBlock * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

bool on(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// The vector path (16 bytes of x a load) where D, the row stride and every
// pointer allow it; one value a load otherwise.
template <typename T, typename W>
cudaError_t launch_types(const Params& p, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr size_t kWeightBytes = sizeof(W) * kVec;
  const bool vector = p.width % kVec == 0 && p.x_stride % kVec == 0 && on(p.x, 16) &&
                      on(p.y, 16) && on(p.w, kWeightBytes) &&
                      (p.b == nullptr || on(p.b, kWeightBytes));
  return vector ? launch_width<T, W, kVec>(p, stream) : launch_width<T, W, 1>(p, stream);
}

template <typename T>
cudaError_t launch_weight(int w_dtype, const Params& p, cudaStream_t stream) {
  switch (w_dtype) {
    case 0: return launch_types<T, float>(p, stream);
    case 1: return launch_types<T, __nv_bfloat16>(p, stream);
    default: return launch_types<T, __half>(p, stream);
  }
}

}  // namespace

// x [rows, width] with row stride x_stride (elements) and unit stride along a
// row; weight and bias (or null) [width], contiguous; y [rows, width]
// contiguous.  Dtype codes, of x (and y) and of weight (and bias): 0 float32,
// 1 bf16, 2 fp16.  Returns the CUDA error of the launch (0 on success); never
// synchronises.
extern "C" int layer_norm(const void* x, const void* weight, const void* bias, void* y,
                          long long rows, long long width, long long x_stride, int x_dtype,
                          int w_dtype, float eps, void* stream) {
  if (rows <= 0 || width <= 0 || width > kMaxWidth || x_stride < 0 || rows > INT_MAX ||
      x_dtype < 0 || x_dtype > 2 || w_dtype < 0 || w_dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.w = weight;
  p.b = bias;
  p.y = y;
  p.rows = rows;
  p.x_stride = x_stride;
  p.width = static_cast<int>(width);
  p.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = launch_weight<float>(w_dtype, p, s); break;
    case 1: err = launch_weight<__nv_bfloat16>(w_dtype, p, s); break;
    default: err = launch_weight<__half>(w_dtype, p, s); break;
  }
  return static_cast<int>(err);
}
