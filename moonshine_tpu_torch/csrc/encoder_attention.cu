// Encoder self-attention for Hopper (sm_90a), plain C interface: the packed
// kernel (K1) and the head-major kernel (K2), one template.
//
// K1, `encoder_attention_packed`, replaces the TPU kernel `_packed_kernel`
// in moonshine_tpu/ops/encoder_attention.py.  K2, `encoder_attention_hm`,
// replaces `_attn_kernel` of the same file.  Per (batch row b, head h):
//
//   logits = q_h . k_h^T * hd^-0.5     float32 accumulation
//   masked keys -> -1e9                a row with no valid key is uniform
//   w = softmax(logits) in float32     K1 rounds w to the I/O dtype; K2 keeps
//                                      it in float32, as `_attn_kernel` does
//   out_h = w . v_h                    float32 accumulation, rounded to I/O
//
// Layouts are the JAX ones, read in place with no relayout.  K1: q and v
// are [B, T, H*hd] (head h is the column slice [h*hd, (h+1)*hd)), kt is
// dim-major [B, H*hd, T].  K2: q, k and v are [B, T, H, hd], the same
// addresses as K1's q and v (head stride hd, time stride H*hd); the JAX
// wrapper's transposes to [B, H, T, hd] are not needed.  The mask is bool
// [B, T] (or null), out has q's layout.  I/O is float32 or bf16.
//
// What bounds it.  One call moves 4*B*T*D*itemsize bytes of q, k, v and
// out plus the B*T mask, and does 4*B*H*T^2*hd operations (two products of
// 2*T^2*hd each): the counts of the Pallas cost_estimate.  At the Base
// bench shape (B=512, T=384, H=8, hd=52, bf16) that is 654 MB, at least
// 0.195 ms at 3.35 TB/s, and 126 GFLOP, at least 0.127 ms at 989 TFLOP/s
// on the tensor cores: the memory bound is the one to beat.
//
// What this simple design does about it.  It is written to be right first:
// it computes the exact softmax (the row max and sum over every key before
// any weight is formed) and, for K1, rounds the weights to the I/O dtype
// before the second product, as the TPU kernel does; an online softmax
// would round elsewhere.  One block of 128 threads takes 16 query rows of
// one (b, h).  It keeps their float32 logits rows in shared memory (16*T*4
// bytes: 24 KB at T=384), so q, k and v are each read from device memory by
// the blocks that need them with no logits traffic to device memory.  Keys
// and values pass through shared memory in tiles of 64.  The products run
// on the float32 FMA units, not the tensor cores (bf16 products are exact
// in float32, so this is the "bf16 operands, float32 accumulation" of the
// TPU kernels, and float32 I/O stays full float32 with no TF32).  Each
// (b, h)'s K and V are read once per 16-row block, from L2 after the
// first.  So the kernel is bound by instruction issue and shared-memory
// traffic, far above the memory bound: on an H100 SXM at 700 W K1 takes
// 28.4 ms at the bench shape (chip_smoke.py), where the P.V loop spends an
// address computation, a predicate and a shared-memory load on every FMA
// and leaves 24 of 128 threads idle at head_dim 52.  Tensor-core products
// (mma.sync or wgmma), TMA and a ring of tiles are the work of a later
// change.
//
// The two kernels differ in two places only, chosen by kHeadMajor.  K2's
// keys arrive time-major, so its key tile is stored key by key with a row
// of head_dim + 1 floats: the global reads stay coalesced along head_dim and
// the logits loop's reads (one key per thread) fall in distinct banks.  And
// K2 leaves the weights in float32.  K1's instantiation is the code of the
// packed kernel as it was.
//
// Limits: head_dim <= 128; T as long as 16 logits rows fit the block's
// shared memory (about 3000 frames, 77 s of audio); B and H <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;               // query rows per block
constexpr int kKeys = 64;               // keys (or values) per staged tile
constexpr int kRowGroups = kThreads / kKeys;
constexpr int kRowsPerThread = kRows / kRowGroups;  // 8
constexpr float kNegInf = -1e9f;

static_assert(kRowsPerThread == 8, "the logits loop reads 8 rows as two float4");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Floats of the key/value tile: K1's keys [head_dim][kKeys] and both
// kernels' values [kKeys][head_dim] fit head_dim * kKeys; K2's keys
// [kKeys][head_dim + 1] need one more column.
__host__ __device__ __forceinline__ int tile_floats(int head_dim, bool head_major) {
  return head_dim * kKeys + (head_major ? kKeys : 0);
}

size_t shared_bytes(int seq, int head_dim, bool head_major) {
  return sizeof(float) * (static_cast<size_t>(head_dim) * kRows +
                          static_cast<size_t>(tile_floats(head_dim, head_major)) +
                          static_cast<size_t>(kRows) * seq);
}

template <typename T, bool kHeadMajor>
__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ mask,
                         T* __restrict__ out, int seq, int heads, int head_dim, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [head_dim][kRows]: q tile, transposed
  float* tile = qs + head_dim * kRows;    // keys (see tile_floats) / [kKeys][head_dim] values
  float* w = tile + tile_floats(head_dim, kHeadMajor);  // [kRows][seq]: logits, then weights

  const int dim = heads * head_dim;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  // q[b, t, h*hd + d], v[b, t, h*hd + d] and (K2) k[b, t, h, d] sit at
  // base_qv + t*dim + d; (K1) kt[b, h*hd + d, t] at base_kt + d*seq + t.
  const size_t base_qv = static_cast<size_t>(b) * seq * dim + static_cast<size_t>(h) * head_dim;
  const size_t base_kt = static_cast<size_t>(b) * dim * seq + static_cast<size_t>(h) * head_dim * seq;

  for (int i = tid; i < kRows * head_dim; i += kThreads) {
    const int r = i / head_dim, d = i % head_dim, t = row0 + r;
    qs[d * kRows + r] = t < seq ? to_f32(q[base_qv + static_cast<size_t>(t) * dim + d]) : 0.f;
  }

  // Logits: each thread owns key column j of the tile and 8 query rows.
  const int j = tid % kKeys, rg = tid / kKeys;
  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed; qs is written
    if constexpr (kHeadMajor) {
      for (int i = tid; i < kKeys * head_dim; i += kThreads) {
        const int jj = i / head_dim, d = i % head_dim, t = k0 + jj;
        tile[jj * (head_dim + 1) + d] =
            t < seq ? to_f32(k[base_qv + static_cast<size_t>(t) * dim + d]) : 0.f;
      }
    } else {
      for (int i = tid; i < head_dim * kKeys; i += kThreads) {
        const int d = i / kKeys, t = k0 + i % kKeys;
        tile[i] = t < seq ? to_f32(k[base_kt + static_cast<size_t>(d) * seq + t]) : 0.f;
      }
    }
    __syncthreads();
    float acc[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < head_dim; ++d) {
      const float kv = kHeadMajor ? tile[j * (head_dim + 1) + d] : tile[d * kKeys + j];
      const float4* qrow = reinterpret_cast<const float4*>(qs + d * kRows + rg * kRowsPerThread);
      const float4 qa = qrow[0], qb = qrow[1];
      acc[0] = fmaf(qa.x, kv, acc[0]);
      acc[1] = fmaf(qa.y, kv, acc[1]);
      acc[2] = fmaf(qa.z, kv, acc[2]);
      acc[3] = fmaf(qa.w, kv, acc[3]);
      acc[4] = fmaf(qb.x, kv, acc[4]);
      acc[5] = fmaf(qb.y, kv, acc[5]);
      acc[6] = fmaf(qb.z, kv, acc[6]);
      acc[7] = fmaf(qb.w, kv, acc[7]);
    }
    const int t = k0 + j;
    if (t < seq) {
      const bool valid = mask == nullptr || mask[static_cast<size_t>(b) * seq + t] != 0;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        w[(rg * kRowsPerThread + r) * seq + t] = valid ? acc[r] * scale : kNegInf;
      }
    }
  }
  __syncthreads();

  // Exact softmax, one warp per row: max, then exp and sum, then the
  // weights (K1: rounded to the I/O dtype; K2: float32).
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* row = w + r * seq;
    float m = __int_as_float(0xff800000);  // -inf
    for (int t = lane; t < seq; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < seq; t += 32) {
      const float p = expf(row[t] - m);
      row[t] = p;
      s += p;
    }
    s = warp_sum(s);
    if constexpr (kHeadMajor) {
      for (int t = lane; t < seq; t += 32) row[t] = row[t] / s;
    } else {
      for (int t = lane; t < seq; t += 32) row[t] = to_f32(from_f32<T>(row[t] / s));
    }
  }

  // Output: each thread owns head column dcol for rows rg2, rg2 + groups, ...
  const int groups = kThreads / head_dim;  // >= 1 since head_dim <= 128
  const int dcol = tid % head_dim, rg2 = tid / head_dim;
  float o[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) o[i] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // softmax done / the previous tile is consumed
    for (int i = tid; i < kKeys * head_dim; i += kThreads) {
      const int t = k0 + i / head_dim, d = i % head_dim;
      tile[i] = t < seq ? to_f32(v[base_qv + static_cast<size_t>(t) * dim + d]) : 0.f;
    }
    __syncthreads();
    if (rg2 < groups) {
      const int nk = min(kKeys, seq - k0);
      for (int jj = 0; jj < nk; ++jj) {
        const float vv = tile[jj * head_dim + dcol];
        const float* wcol = w + k0 + jj;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = rg2 + i * groups;
          if (r < kRows) o[i] = fmaf(wcol[r * seq], vv, o[i]);
        }
      }
    }
  }
  if (rg2 < groups) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rg2 + i * groups, t = row0 + r;
      if (r < kRows && t < seq) out[base_qv + static_cast<size_t>(t) * dim + dcol] = from_f32<T>(o[i]);
    }
  }
}

template <typename T, bool kHeadMajor>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int batch, int seq, int heads, int head_dim, float scale,
                   cudaStream_t stream) {
  const size_t smem = shared_bytes(seq, head_dim, kHeadMajor);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(encoder_attention_kernel<T, kHeadMajor>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  encoder_attention_kernel<T, kHeadMajor><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), seq, heads, head_dim, scale);
  return cudaGetLastError();
}

template <bool kHeadMajor>
int run(const void* q, const void* k, const void* v, const void* mask, void* out, int batch,
        int seq, int heads, int head_dim, int dtype, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 || head_dim > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, kHeadMajor>(q, k, v, mask, out, batch, seq, heads, head_dim, scale, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, kHeadMajor>(q, k, v, mask, out, batch, seq, heads, head_dim,
                                            scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bf16.  mask may be null (every key valid).
// Each returns the CUDA error of the launch (0 on success); neither
// synchronises.

// K1: q, v [B, T, H*hd], kt [B, H*hd, T]; weights rounded to the I/O dtype.
extern "C" int encoder_attention_packed(const void* q, const void* kt, const void* v,
                                        const void* mask, void* out, int batch, int seq,
                                        int heads, int head_dim, int dtype, float scale,
                                        void* stream) {
  return run<false>(q, kt, v, mask, out, batch, seq, heads, head_dim, dtype, scale, stream);
}

// K2: q, k, v [B, T, H, hd]; weights kept in float32.
extern "C" int encoder_attention_hm(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int batch, int seq,
                                    int heads, int head_dim, int dtype, float scale,
                                    void* stream) {
  return run<true>(q, k, v, mask, out, batch, seq, heads, head_dim, dtype, scale, stream);
}
