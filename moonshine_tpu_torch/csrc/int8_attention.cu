// Fused int8-KV decode attention for Hopper (sm_90a), plain C interface: K5.
//
// Replaces no TPU kernel.  `attention_dm_q8` of moonshine_tpu/ops/int8_kv.py
// is plain JAX, which XLA fuses; its PyTorch counterpart, run eagerly, formed
// a float copy of the whole int8 cache on every call (`k_q.float()`,
// `v_q.to(q.dtype)`), then a float32 batched GEMV over it: 12 launches a call
// and half the service's device time in dtype copies.  This kernel reads the
// int8 caches and their scales in place and computes the whole function in
// one launch.  Per (batch row b, head h) and query row i, with K and V
// dim-major [hd, T]:
//
//   logits[t] = (sum_d q[i,d] k_q[d,t]) * (k_s[t] * hd^-0.5)   float32
//   masked t -> -1e9                      a row with no valid key is uniform
//   w = softmax(logits) over all T        float32: the row max and sum over
//                                         every key before any weight
//   wv[t] = io(w[t] * v_s[t])             rounded to q's dtype
//   out[i,d] = io(sum_t wv[t] v_q[d,t])   float32 accumulation
//
// Grouped heads (GQA): the caches may hold fewer heads than q, H_kv dividing
// H; q head h reads cache head h / (H / H_kv), in place (no copy of the
// cache is formed).  With H_kv = H that is head h itself, the same
// addresses and sums as before grouped heads were taken.
//
// These are the plain version's rounding places (ops/int8_kv.py); the two
// differ only in the order of their float32 sums.  q is bf16 or float32;
// the products of int8 values with bf16 or float32 values are exact in
// float32, so the FMAs here compute what the plain version's float32
// products do.
//
// What bounds it.  Bytes: every int8 byte of K and V and every scale read
// once, q and the mask read and out written once.  At the service's decode
// shape (32 streams, H=11, hd=64, s=1, the 3,200-column memory bucket) that
// is 144.2 MB of int8 and 0.9 MB of scales, 0.0433 ms at 3.35 TB/s, against
// 0.58 GFLOP; offline (B=64, H=8, hd=52, s=1, 256 frames) 13.6 MB, 0.0041
// ms.  So at s=1 the kernel is a GEMV bound by bytes; what it spends its
// time on is the latency of each block's dependent trips to device memory.
// The service's verify (s up to 129) does 4*B*H*s*T*hd operations (37.2
// GFLOP at s=129, T=3,200) on the FMA units (67 TFLOP/s).
//
// What the design does.  One block of 256 threads per (b, h, tile of R query
// rows); R is 1, 4, 8 or 16, the smallest that holds s, made smaller while
// the tile's float32 logits rows (R x T) do not fit in shared memory
// (choose_plan), so that the whole row's logits stay in shared memory and
// the weights are formed after the exact row max and sum.  Three phases:
//   1. Logits: each thread owns 4 adjacent key columns at a time and walks
//      the hd rows of K, one 4-byte load a row (neighbouring threads on
//      neighbouring addresses), 8 or 16 rows' loads in flight, converting
//      the int8 values in registers and taking R x 4 FMAs with q's values
//      (staged in shared memory as float, [hd][R], read as broadcasts).  It
//      scales, masks and stores the logits and keeps each row's max.
//   2. Softmax: block reductions (warp shuffles, then the warps in order)
//      of each row's max and sum of exp(l - max); then each weight p / sum
//      (correctly rounded), times v_s, rounded to q's dtype, in place.
//   3. P.V: each warp owns 4 rows of V (d0..d0+3) at a time; lane L walks
//      the key columns 16L + 512i .. +16 in order, loading each of the 4
//      rows 4 or 16 bytes at a time and each query row's weights 16 bytes
//      at a time from shared memory, R x 4 float32 partial sums per lane,
//      summed over the warp by shuffles at the end.
// Every int8 byte is read from device memory once per query tile, so at s=1
// once.  Two parameter sets, chosen by the shape, that differ only in how
// many loads they keep in flight: where a decode step's blocks (B*H at s=1)
// fit the card three to an SM and T >= 256 (the service), the wide set (16
// K rows' loads in flight, 16-byte V loads, at most 80 registers) takes
// fewer trips to device memory; elsewhere (the offline batch's 512 blocks)
// the narrow set (8 rows, 4-byte V loads, at most 64 registers) keeps four
// blocks an SM, so that every block is resident at once.  On an H100 the
// wide set took the 3,200-column service call from 0.100 to 0.084 ms, and
// would take the offline cross attention from 0.018 to 0.027 ms.  Both sum
// in the same order, so a row's result does not depend on the set, on B,
// on H or on its place in the grid, and is the same from run to run.  A K
// or V row that does not start on an aligned boundary (an odd cache
// length, such as the offline decode's self cache of 41 columns) is read a
// byte at a time.
//
// Limits: hd <= 128; the tile's shared memory (choose_plan) within 227 KB,
// which at R=1 takes T up to 58,032 at hd=64 (ops/int8_kv.py's max_columns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr size_t kSmemLimit = 232448;   // what one Hopper block may opt into
constexpr size_t kSmemDefault = 49152;  // without the opt-in

struct Params {
  const void* q;
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
  const uint8_t* mask;  // bool, or null
  void* out;            // [B, s, H, hd], contiguous
  long long q_sb, q_ss, q_sh, q_sd;  // element strides; K, V and scales have T stride 1
  long long k_sb, k_sh, k_sd;
  long long ks_sb, ks_sh;
  long long v_sb, v_sh, v_sd;
  long long vs_sb, vs_sh;
  long long m_sb, m_sh, m_ss, m_st;  // 0 where the mask broadcasts
  int heads, rows, cols, hd, tiles;  // H (q's heads), s, T, hd, ceil(s / R)
  int group;                         // q heads a cache head serves: H / H_kv
  int k_vec;                         // every K row starts on a 4-byte boundary
  int v_align;                       // every V row starts on a multiple of these bytes
  float scale;                       // hd^-0.5
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename Tq>
__device__ __forceinline__ float round_io(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_io<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// row[t0 .. t0 + 4) as floats (exact), zeros past T.  kVec: one 4-byte load
// (the caller guarantees alignment and t0 + 4 <= T).
template <bool kVec>
__device__ __forceinline__ void load4(const int8_t* __restrict__ row, int t0, int T,
                                      float (&f)[4]) {
  if (kVec) {
    const char4 c = *reinterpret_cast<const char4*>(row + t0);
    f[0] = c.x;
    f[1] = c.y;
    f[2] = c.z;
    f[3] = c.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = t0 + j < T ? static_cast<float>(row[t0 + j]) : 0.f;
  }
}

// row[t0 .. t0 + 16) as floats (exact), zeros past T.  kVec: one 16-byte
// load (the caller guarantees alignment and t0 + 16 <= T).
template <bool kVec>
__device__ __forceinline__ void load16(const int8_t* __restrict__ row, int t0, int T,
                                       float (&f)[16]) {
  if (kVec) {
    const int4 w = *reinterpret_cast<const int4*>(row + t0);
    const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      f[j] = static_cast<float>(static_cast<int8_t>(words[j / 4] >> (8 * (j % 4))));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) f[j] = t0 + j < T ? static_cast<float>(row[t0 + j]) : 0.f;
  }
}

// q's values of the tile's R rows at one d (q_s is [hd][R]).
template <int R>
__device__ __forceinline__ void load_q(const float* q_s, float (&qd)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const float4 x = *reinterpret_cast<const float4*>(q_s + r);
      qd[r] = x.x;
      qd[r + 1] = x.y;
      qd[r + 2] = x.z;
      qd[r + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) qd[r] = q_s[r];
  }
}

// acc[r][j] = sum_d q_s[d][r] * k[d][t0 + j] over d < hd, kRows rows' loads
// in flight.
template <int R, int kRows, bool kVec>
__device__ __forceinline__ void dot_cols(const int8_t* __restrict__ k, long long k_sd,
                                         const float* q_s, int hd, int t0, int T,
                                         float (&acc)[R][4]) {
#pragma unroll kRows
  for (int d = 0; d < hd; ++d) {
    float kf[4];
    load4<kVec>(k + d * k_sd, t0, T, kf);
    float qd[R];
    load_q<R>(q_s + d * R, qd);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(qd[r], kf[j], acc[r][j]);
    }
  }
}

// acc[r][i] += sum over the 16 columns from t0 of w[r][t] * v[d0 + i][t], in
// column order, read kBytes (4 or 16) columns of each of the 4 rows at a
// time: the sums do not depend on kBytes.
template <int R, int kBytes, bool kVec>
__device__ __forceinline__ void pv_cols(const int8_t* __restrict__ v, long long v_sd,
                                        const float* w_s, int tp, int d0, int hd, int t0,
                                        int T, float (&acc)[R][4]) {
#pragma unroll
  for (int m = 0; m < 16; m += kBytes) {
    float vf[4][kBytes];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (d0 + i >= hd) {
#pragma unroll
        for (int j = 0; j < kBytes; ++j) vf[i][j] = 0.f;
      } else if constexpr (kBytes == 16) {
        load16<kVec>(v + (d0 + i) * v_sd, t0 + m, T, vf[i]);
      } else {
        load4<kVec>(v + (d0 + i) * v_sd, t0 + m, T, vf[i]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j4 = 0; j4 < kBytes; j4 += 4) {
        const float4 w = *reinterpret_cast<const float4*>(w_s + r * tp + t0 + m + j4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[r][i] = fmaf(w.x, vf[i][j4], acc[r][i]);
          acc[r][i] = fmaf(w.y, vf[i][j4 + 1], acc[r][i]);
          acc[r][i] = fmaf(w.z, vf[i][j4 + 2], acc[r][i]);
          acc[r][i] = fmaf(w.w, vf[i][j4 + 3], acc[r][i]);
        }
      }
    }
  }
}

// Each row's max (kMax) or sum over the block, into out[0 .. R): warp
// shuffles, then the warps' values in warp order, so the sum's order is
// fixed.  Ends with a barrier.
template <int R, bool kMax>
__device__ __forceinline__ void block_reduce(float (&x)[R], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[r], o);
      x[r] = kMax ? fmaxf(x[r], y) : x[r] + y;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) red[warp * R + r] = x[r];
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float a = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      const float b = red[w * R + threadIdx.x];
      a = kMax ? fmaxf(a, b) : a + b;
    }
    out[threadIdx.x] = a;
  }
  __syncthreads();
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// kWide (R = 1 only): 16 K rows' loads in flight and 16-byte V loads, at
// most 80 registers (three blocks an SM); else 8 rows and 4-byte loads, the
// narrow set for R = 1 at most 64 registers (four blocks an SM).  Both sum
// in the same order.
template <typename Tq, int R, bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? 3 : R == 1 ? 4 : 1)
    int8_attention_kernel(const Params p) {
  static_assert(!kWide || R == 1, "the wide set is for single query rows");
  constexpr int kRows = kWide ? 16 : 8, kBytes = kWide ? 16 : 4;
  extern __shared__ __align__(16) float smem[];
  const int T = p.cols, hd = p.hd, tp = round16(T);
  float* w_s = smem;                  // [R][tp]: logits, then exp, then the weights
  float* q_s = w_s + R * tp;          // [hd][R]
  float* red = q_s + hd * R;          // [kWarps][R]
  float* row_max = red + kWarps * R;  // [R]
  float* row_sum = row_max + R;       // [R]

  int bid = blockIdx.x;
  const int tile = bid % p.tiles;
  bid /= p.tiles;
  const int h = bid % p.heads;
  const int b = bid / p.heads;
  const int hk = h / p.group;  // the cache head q head h reads
  const int row0 = tile * R;
  const int rows = min(R, p.rows - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Tq* q = static_cast<const Tq*>(p.q) + b * p.q_sb + h * p.q_sh + row0 * p.q_ss;
  for (int e = tid; e < hd * R; e += kThreads) {
    const int d = e / R, r = e - d * R;
    q_s[e] = r < rows ? to_float(q[r * p.q_ss + d * p.q_sd]) : 0.f;
  }
  __syncthreads();

  // 1. Logits, scaled and masked, into w_s; each row's max.
  const int8_t* k = p.k + b * p.k_sb + hk * p.k_sh;
  const float* ks = p.ks + b * p.ks_sb + hk * p.ks_sh;
  const uint8_t* mask =
      p.mask == nullptr ? nullptr : p.mask + b * p.m_sb + h * p.m_sh + row0 * p.m_ss;
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
  for (int t0 = tid * 4; t0 < T; t0 += kThreads * 4) {
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    }
    if (p.k_vec && t0 + 4 <= T) {
      dot_cols<R, kRows, true>(k, p.k_sd, q_s, hd, t0, T, acc);
    } else {
      dot_cols<R, kRows, false>(k, p.k_sd, q_s, hd, t0, T, acc);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j;
      if (t >= T) break;
      const float sc = ks[t] * p.scale;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float l = acc[r][j] * sc;
        if (r >= rows) {
          l = 0.f;  // a padding row of the last tile: never written out
        } else if (mask != nullptr && !mask[r * p.m_ss + t * p.m_st]) {
          l = kNegInf;
        }
        w_s[r * tp + t] = l;
        mx[r] = fmaxf(mx[r], l);
      }
    }
  }
  block_reduce<R, true>(mx, red, row_max);

  // 2. Softmax over every column, then the weights times v_s, rounded to
  // q's dtype; columns T .. tp hold zeros for phase 3's 16-byte loads.
  float sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sum[r] = 0.f;
  for (int t = tid; t < T; t += kThreads) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float e = expf(w_s[r * tp + t] - row_max[r]);
      w_s[r * tp + t] = e;
      sum[r] += e;
    }
  }
  block_reduce<R, false>(sum, red, row_sum);
  const float* vs = p.vs + b * p.vs_sb + hk * p.vs_sh;
  for (int t = tid; t < tp; t += kThreads) {
    const float s_t = t < T ? vs[t] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      w_s[r * tp + t] = t < T ? round_io<Tq>(__fdiv_rn(w_s[r * tp + t], row_sum[r]) * s_t) : 0.f;
    }
  }
  __syncthreads();

  // 3. P.V: warp-owned quads of V rows, lanes over columns.
  const int8_t* v = p.v + b * p.v_sb + hk * p.v_sh;
  Tq* out = static_cast<Tq*>(p.out);
  for (int d0 = warp * 4; d0 < hd; d0 += kWarps * 4) {
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
    }
    for (int t0 = lane * 16; t0 < T; t0 += 32 * 16) {
      if (p.v_align >= kBytes && t0 + 16 <= T) {
        pv_cols<R, kBytes, true>(v, p.v_sd, w_s, tp, d0, hd, t0, T, acc);
      } else {
        pv_cols<R, kBytes, false>(v, p.v_sd, w_s, tp, d0, hd, t0, T, acc);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], o);
        // Every lane holds the sum; the stores are spread over the lanes.
        if (lane == (r * 4 + i) % 32 && r < rows && d0 + i < hd) {
          const long long row = static_cast<long long>(b) * p.rows + row0 + r;
          store(out + (row * p.heads + h) * hd + d0 + i, acc[r][i]);
        }
      }
    }
  }
}

size_t smem_bytes(int R, long long T, int hd) {
  return 4ull * (static_cast<size_t>(R) * round16(static_cast<int>(T)) + hd * R + kWarps * R +
                 2 * R);
}

struct Plan {
  int rows;  // R, 0 if nothing fits
  bool wide;
  size_t smem;
};

// The card's SMs (cached per device).
int sm_count() {
  static int counts[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return 0;
  if (counts[device] == 0) {
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  }
  return counts[device];
}

// The query tile: the smallest of 1, 4, 8, 16 that holds s, made smaller
// while its logits rows do not fit in shared memory (rows = 0 if even one
// row does not; ops/int8_kv.max_columns mirrors that limit).  The wide set
// where R = 1, T >= 256 and the blocks fit three to an SM.
Plan choose_plan(long long B, long long H, long long s, long long T, int hd) {
  int R = s <= 1 ? 1 : s <= 4 ? 4 : s <= 8 ? 8 : 16;
  while (R > 1 && smem_bytes(R, T, hd) > kSmemLimit) R = R == 16 ? 8 : R == 8 ? 4 : 1;
  const size_t smem = smem_bytes(R, T, hd);
  if (smem > kSmemLimit) return {0, false, 0};
  const long long blocks = B * H * ((s + R - 1) / R);
  return {R, R == 1 && T >= 256 && blocks <= 3LL * sm_count(), smem};
}

template <typename Tq, int R, bool kWide>
cudaError_t launch(const Params& p, size_t smem, long long blocks, cudaStream_t stream) {
  auto kernel = int8_attention_kernel<Tq, R, kWide>;
  if (smem > kSmemDefault) {
    static uint64_t opted_in = 0;  // a bit per device
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= 64) return cudaErrorInvalidDevice;
    if (!(opted_in >> device & 1)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemLimit));
      if (err != cudaSuccess) return err;
      opted_in |= uint64_t{1} << device;
    }
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tq>
cudaError_t launch_plan(const Plan& plan, const Params& p, long long blocks,
                        cudaStream_t stream) {
  switch (plan.rows) {
    case 1:
      return plan.wide ? launch<Tq, 1, true>(p, plan.smem, blocks, stream)
                       : launch<Tq, 1, false>(p, plan.smem, blocks, stream);
    case 4: return launch<Tq, 4, false>(p, plan.smem, blocks, stream);
    case 8: return launch<Tq, 8, false>(p, plan.smem, blocks, stream);
    default: return launch<Tq, 16, false>(p, plan.smem, blocks, stream);
  }
}

// The boundary (16, 4 or 1 bytes) that every row of a cache starts on.
int aligned(const void* base, long long sb, long long sh, long long sd) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(base) | static_cast<uintptr_t>(sb) |
                         static_cast<uintptr_t>(sh) | static_cast<uintptr_t>(sd);
  return bits % 16 == 0 ? 16 : bits % 4 == 0 ? 4 : 1;
}

}  // namespace

// q [B, s, H, hd] (q_dtype 0: float32, 1: bf16); k, v [B, H_kv, hd, T] int8;
// ks, vs [B, H_kv, T] float32; mask bool broadcast to [B, H, s, T] (strides 0
// where it broadcasts) or null; out [B, s, H, hd] contiguous in q's dtype.
// shape: B, H, s, T, hd, H_kv (H_kv divides H).  strides (elements; K, V and the scales have T
// stride 1): q b s h d, k b h d, ks b h, v b h d, vs b h, mask b h s t.
// Returns the CUDA error of the launch (0 on success); never synchronises.
extern "C" int int8_attention(const void* q, const void* k, const void* ks, const void* v,
                              const void* vs, const void* mask, void* out,
                              const long long* shape, const long long* strides, int q_dtype,
                              float scale, void* stream) {
  const long long B = shape[0], H = shape[1], S = shape[2], T = shape[3], hd = shape[4];
  const long long Hkv = shape[5];
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0 || hd <= 0 || hd > kMaxHeadDim || T > INT_MAX / 2 ||
      Hkv <= 0 || H % Hkv != 0 ||
      S > INT_MAX / 2 || (q_dtype != 0 && q_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = choose_plan(B, H, S, T, static_cast<int>(hd));
  if (plan.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (S + plan.rows - 1) / plan.rows;
  const long long blocks = B * H * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = strides;
  Params p;
  p.q = q;
  p.k = static_cast<const int8_t*>(k);
  p.ks = static_cast<const float*>(ks);
  p.v = static_cast<const int8_t*>(v);
  p.vs = static_cast<const float*>(vs);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = out;
  p.q_sb = st[0], p.q_ss = st[1], p.q_sh = st[2], p.q_sd = st[3];
  p.k_sb = st[4], p.k_sh = st[5], p.k_sd = st[6];
  p.ks_sb = st[7], p.ks_sh = st[8];
  p.v_sb = st[9], p.v_sh = st[10], p.v_sd = st[11];
  p.vs_sb = st[12], p.vs_sh = st[13];
  p.m_sb = st[14], p.m_sh = st[15], p.m_ss = st[16], p.m_st = st[17];
  p.heads = static_cast<int>(H);
  p.rows = static_cast<int>(S);
  p.cols = static_cast<int>(T);
  p.hd = static_cast<int>(hd);
  p.tiles = static_cast<int>(tiles);
  p.group = static_cast<int>(H / Hkv);
  p.k_vec = aligned(k, p.k_sb, p.k_sh, p.k_sd) >= 4;
  p.v_align = aligned(v, p.v_sb, p.v_sh, p.v_sd);
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = q_dtype == 0 ? launch_plan<float>(plan, p, blocks, s)
                                       : launch_plan<__nv_bfloat16>(plan, p, blocks, s);
  return static_cast<int>(err);
}
