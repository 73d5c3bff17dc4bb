// Encoder self-attention for Hopper (sm_90a), plain C interface: the packed
// kernel (K1) and the head-major kernel (K2).
//
// K1, `encoder_attention_packed`, replaces the TPU kernel `_packed_kernel`
// in moonshine_tpu/ops/encoder_attention.py.  K2, `encoder_attention_hm`,
// replaces `_attn_kernel` of the same file.  Per (batch row b, head h):
//
//   logits = q_h . k_h^T * hd^-0.5     I/O-dtype operands, float32 accumulation
//   masked keys -> -1e9                a row with no valid key is uniform
//   w = softmax(logits) in float32     exact: the row max and sum over every
//                                      key before any weight is formed; K1
//                                      rounds w to the I/O dtype, K2 keeps it
//                                      in float32, as `_attn_kernel` does
//   out_h = w . v_h                    float32 accumulation, rounded to I/O
//
// Layouts are the JAX ones, read in place with no relayout.  K1: q and v
// are [B, T, H*hd] (head h is the column slice [h*hd, (h+1)*hd)), kt is
// dim-major [B, H*hd, T].  K2: q, k and v are [B, T, H, hd], the same
// addresses as K1's q and v (head stride hd, time stride H*hd).  The mask is
// bool [B, T] (or null), out has q's layout.
//
// Two routes, chosen by the I/O dtype.
//
// bf16: the tensor-core kernel (`encoder_attention_mma_kernel`).
//   What bounds it.  At the Base bench shape (B=512, T=384, H=8, hd=52) one
//   call moves 654.3 MB (q, k, v and out once each): 0.1953 ms at 3.35 TB/s.
//   Its products, with hd padded to the mma tiles (Q.K^T over 64 dims, P.V
//   over 56 columns), are 77.3 + 67.6 GFLOP, 0.1465 ms at 989 TFLOP/s, for
//   K1; K2 runs P.V three times (below): 77.3 + 202.9 GFLOP, 0.2833 ms.  So
//   K1 is bound by bytes and K2 by operations.  No bound counts the 604 M
//   exps or the logits rows' traffic in shared memory (9.7 GB), and those,
//   with the latency of a block that keeps 8 warps on an SM, are what the
//   kernel spends its time on: 2.24 ms for K1 and 2.81 ms for K2 on an H100
//   SXM at 700 W (chip_smoke.py), 11x their bounds.
//   What the design does.  Each warp owns 16 query rows of one (b, h), one
//   m16 tile; a block of 1-8 warps (chosen from T alone, see choose_warps)
//   shares the K/V tiles.  Q.K^T and P.V run as
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with operands from shared
//   memory by ldmatrix (.trans for K1's dim-major key tile and for V).  The
//   Q fragments stay in registers for the whole key loop.  Keys and then
//   values stream through one ring of kStages buffers of 64-key tiles filled
//   by cp.async, two tiles in flight while one is multiplied (the first
//   value tiles during the softmax), one block barrier per tile.  The copy
//   width is the widest of 16, 8 and 4 bytes that the addresses allow: a
//   head's slice of q, v and K2's k starts at h*hd*2 bytes (104 B at hd=52:
//   8-byte pieces), and kt's rows are 2*T bytes apart (16-byte pieces at
//   T=384); cp.async has no 2-byte form, so kt at an odd T (and any operand
//   at an odd hd) is copied by plain 2-byte loads and stores.  Padding is
//   written as zeros in shared memory and never loaded: columns hd..63 of a
//   head in K1's q are the next head's values.  The softmax is the exact one
//   of the TPU kernels: each warp writes its scaled, masked logits from the
//   accumulator fragments into float32 rows in shared memory (row stride T
//   rounded up to 64, plus 8 floats, so the float2 stores and loads of a
//   fragment fall in distinct banks) and keeps each row's max in registers
//   as it goes; then each lane takes one key of all 16 rows at a time (16
//   independent exps) for exp and the row sums over every key; then P.V
//   forms each weight p / sum, correctly rounded (see divide), as it builds
//   its A fragments.  K1 rounds the weight to bf16: that is the A operand.
//   K2 keeps it float32: it splits w into hi = bf16(w), mid = bf16(w - hi)
//   and lo = bf16(w - hi - mid) and runs three mma passes into one float32
//   accumulator.  Nothing is split over keys or shared across heads, and a
//   row's arithmetic does not depend on B, H, the block's warp count or its
//   place in the grid, so a batch row run alone gives the same bits.
//   Shared memory at T=384, hd=52: 8 warps, 200,704 B of logits rows (the Q
//   tile is staged there first) and three 9,216 B ring buffers: 228,352 B,
//   one block of 8 warps per SM.  At T=2,665, one warp: 200,192 B.  Longest
//   T: 3,136 at hd 49-64 (the wrapper's max_frames).  nvcc -Xptxas -v (CUDA
//   12.8, sm_90a), hd 49-64: 117 registers for K1, 119 for K2 (96-128 over
//   all head_dim classes), no spills.
//
// float32: the FMA kernel (`encoder_attention_fma_kernel`), the exact
//   float32 route: no TF32, so float32 I/O keeps full float32 products.  One
//   block of 128 threads takes 16 query rows of one (b, h), keeps their
//   logits rows in shared memory and runs both products on the FMA units
//   with keys and values staged synchronously in tiles of 64 (K2's key tile
//   key by key with rows of hd + 1 floats, so its reads stay coalesced and
//   bank-distinct).  Longest T: (58112 - 80*hd - 64) / 16, 3,368 at hd=52.
//   It is issue-bound, far above its bound (67 TFLOP/s of float32 FMA).
//
// Limits: head_dim <= 128; B and H <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// float32 route: FMA units, one block of 128 threads per 16 query rows
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 128;
constexpr int kFmaRows = 16;  // query rows per block
constexpr int kFmaKeys = 64;  // keys (or values) per staged tile
constexpr int kFmaRowGroups = kFmaThreads / kFmaKeys;
constexpr int kFmaRowsPerThread = kFmaRows / kFmaRowGroups;  // 8

static_assert(kFmaRowsPerThread == 8, "the logits loop reads 8 rows as two float4");

// Floats of the key/value tile: K1's keys [head_dim][kFmaKeys] and both
// kernels' values [kFmaKeys][head_dim] fit head_dim * kFmaKeys; K2's keys
// [kFmaKeys][head_dim + 1] need one more column.
__host__ __device__ __forceinline__ int fma_tile_floats(int head_dim, bool head_major) {
  return head_dim * kFmaKeys + (head_major ? kFmaKeys : 0);
}

size_t fma_shared_bytes(int seq, int head_dim, bool head_major) {
  return sizeof(float) * (static_cast<size_t>(head_dim) * kFmaRows +
                          static_cast<size_t>(fma_tile_floats(head_dim, head_major)) +
                          static_cast<size_t>(kFmaRows) * seq);
}

template <bool kHeadMajor>
__global__ void __launch_bounds__(kFmaThreads)
encoder_attention_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const uint8_t* __restrict__ mask,
                             float* __restrict__ out, int seq, int heads, int head_dim,
                             float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [head_dim][kFmaRows]: q tile, transposed
  float* tile = qs + head_dim * kFmaRows;  // keys (see fma_tile_floats) / [kFmaKeys][head_dim] values
  float* w = tile + fma_tile_floats(head_dim, kHeadMajor);  // [kFmaRows][seq]: logits, then weights

  const int dim = heads * head_dim;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kFmaRows;
  const int tid = threadIdx.x;
  // q[b, t, h*hd + d], v[b, t, h*hd + d] and (K2) k[b, t, h, d] sit at
  // base_qv + t*dim + d; (K1) kt[b, h*hd + d, t] at base_kt + d*seq + t.
  const size_t base_qv = static_cast<size_t>(b) * seq * dim + static_cast<size_t>(h) * head_dim;
  const size_t base_kt = static_cast<size_t>(b) * dim * seq + static_cast<size_t>(h) * head_dim * seq;

  for (int i = tid; i < kFmaRows * head_dim; i += kFmaThreads) {
    const int r = i / head_dim, d = i % head_dim, t = row0 + r;
    qs[d * kFmaRows + r] = t < seq ? q[base_qv + static_cast<size_t>(t) * dim + d] : 0.f;
  }

  // Logits: each thread owns key column j of the tile and 8 query rows.
  const int j = tid % kFmaKeys, rg = tid / kFmaKeys;
  for (int k0 = 0; k0 < seq; k0 += kFmaKeys) {
    __syncthreads();  // the previous tile is consumed; qs is written
    if constexpr (kHeadMajor) {
      for (int i = tid; i < kFmaKeys * head_dim; i += kFmaThreads) {
        const int jj = i / head_dim, d = i % head_dim, t = k0 + jj;
        tile[jj * (head_dim + 1) + d] = t < seq ? k[base_qv + static_cast<size_t>(t) * dim + d] : 0.f;
      }
    } else {
      for (int i = tid; i < head_dim * kFmaKeys; i += kFmaThreads) {
        const int d = i / kFmaKeys, t = k0 + i % kFmaKeys;
        tile[i] = t < seq ? k[base_kt + static_cast<size_t>(d) * seq + t] : 0.f;
      }
    }
    __syncthreads();
    float acc[kFmaRowsPerThread] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < head_dim; ++d) {
      const float kv = kHeadMajor ? tile[j * (head_dim + 1) + d] : tile[d * kFmaKeys + j];
      const float4* qrow = reinterpret_cast<const float4*>(qs + d * kFmaRows + rg * kFmaRowsPerThread);
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
      for (int r = 0; r < kFmaRowsPerThread; ++r) {
        w[(rg * kFmaRowsPerThread + r) * seq + t] = valid ? acc[r] * scale : kNegInf;
      }
    }
  }
  __syncthreads();

  // Exact softmax, one warp per row: max, then exp and sum, then the
  // weights (float32 I/O: K1's rounding to the I/O dtype is the identity).
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kFmaRows; r += kFmaThreads / 32) {
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
    for (int t = lane; t < seq; t += 32) row[t] = row[t] / s;
  }

  // Output: each thread owns head column dcol for rows rg2, rg2 + groups, ...
  const int groups = kFmaThreads / head_dim;  // >= 1 since head_dim <= 128
  const int dcol = tid % head_dim, rg2 = tid / head_dim;
  float o[kFmaRows];
#pragma unroll
  for (int i = 0; i < kFmaRows; ++i) o[i] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kFmaKeys) {
    __syncthreads();  // softmax done / the previous tile is consumed
    for (int i = tid; i < kFmaKeys * head_dim; i += kFmaThreads) {
      const int t = k0 + i / head_dim, d = i % head_dim;
      tile[i] = t < seq ? v[base_qv + static_cast<size_t>(t) * dim + d] : 0.f;
    }
    __syncthreads();
    if (rg2 < groups) {
      const int nk = min(kFmaKeys, seq - k0);
      for (int jj = 0; jj < nk; ++jj) {
        const float vv = tile[jj * head_dim + dcol];
        const float* wcol = w + k0 + jj;
#pragma unroll
        for (int i = 0; i < kFmaRows; ++i) {
          const int r = rg2 + i * groups;
          if (r < kFmaRows) o[i] = fmaf(wcol[r * seq], vv, o[i]);
        }
      }
    }
  }
  if (rg2 < groups) {
#pragma unroll
    for (int i = 0; i < kFmaRows; ++i) {
      const int r = rg2 + i * groups, t = row0 + r;
      if (r < kFmaRows && t < seq) out[base_qv + static_cast<size_t>(t) * dim + dcol] = o[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16), cp.async ring of K/V tiles
// ---------------------------------------------------------------------------

constexpr int kTileKeys = 64;         // keys (or values) per ring tile
constexpr int kKeyTiles = kTileKeys / 8;  // n8 tiles of Q.K^T per ring tile
static_assert(kTileKeys % 16 == 0 && kTileKeys <= 128, "mask bits: one uint32 per ring tile");
constexpr int kStages = 3;            // ring buffers: kStages - 1 tiles in flight beside the one in use
static_assert(kStages >= 2, "a ring");
constexpr int kWarpRows = 16;         // query rows per warp: one m16 tile
constexpr int kMaxWarps = 8;
constexpr int kSmemPerBlock = 232448;  // Hopper: the opt-in limit of one block
constexpr int kSmemPerSM = 233472;     // Hopper: 228 KB per SM
constexpr int kSmemReserved = 1024;    // per resident block

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ __forceinline__ int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Shared-memory layout of one block, in bf16 elements for the tiles and
// floats for the logits.  Every tile row is an odd multiple of 16 bytes, so
// the 8 row addresses of an ldmatrix fall in distinct banks.
struct Layout {
  int kd;      // head_dim padded to 16: the depth of Q.K^T
  int nv;      // head_dim padded to 8: the width of P.V
  int qs;      // Q tile row stride [rows][kd + 8]
  int ks;      // K2 key tile row stride [kTileKeys][kd + 8]
  int kts;     // K1 key tile row stride [kd][kTileKeys + 8]
  int vs;      // value tile row stride [kTileKeys][vs]
  int s;       // logits row stride: T rounded up to kTileKeys, + 8 floats
  int ring;    // bytes of one ring buffer (of kStages)
  int logits;  // bytes of the logits region (which first holds the Q tile)
  int total;   // bytes of the block
};

__host__ __device__ __forceinline__ Layout make_layout(int seq, int head_dim, int warps) {
  Layout L;
  L.kd = round_up(head_dim, 16);
  L.nv = round_up(head_dim, 8);
  L.qs = L.kd + 8;
  L.ks = L.kd + 8;
  L.kts = kTileKeys + 8;
  L.vs = (L.nv / 8) % 2 ? L.nv : L.nv + 8;
  L.s = round_up(seq, kTileKeys) + 8;
  L.ring = max3(L.kd * L.kts * 2, kTileKeys * L.ks * 2, kTileKeys * L.vs * 2);
  const int rows = warps * kWarpRows;
  const int logits = rows * L.s * 4, q_tile = rows * L.qs * 2;
  L.logits = logits > q_tile ? logits : q_tile;
  L.total = L.logits + kStages * L.ring;
  return L;
}

// Warps per block, from T (and head_dim) alone: the count that keeps the
// most warps resident on an SM, ties to the larger block (which shares each
// K/V tile among more warps); 0 when even one warp's logits rows do not fit
// a block.
int choose_warps(int seq, int head_dim) {
  const int options[4] = {8, 4, 2, 1};
  int best = 0, best_resident = 0;
  for (int warps : options) {
    const int total = make_layout(seq, head_dim, warps).total;
    if (total > kSmemPerBlock) continue;
    const int resident = kSmemPerSM / (total + kSmemReserved) * warps;
    if (resident > best_resident) {
      best = warps;
      best_resident = resident;
    }
  }
  return best;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One piece of a tile: `width` bytes from global to shared memory, zeros
// where !valid (src must then still be a mapped address).  16, 8 and 4
// bytes go through cp.async; 2 bytes (no cp.async form) by a plain copy.
__device__ __forceinline__ void copy_piece(void* dst, const void* src, int width, bool valid) {
  const uint32_t d = smem_addr(dst);
  const int n = valid ? width : 0;
  if (width == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else if (width == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else if (width == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// How a block's threads walk the pieces of a row copy: `per_row` pieces of
// `width` bytes per row; thread i starts at piece (r0, c0) = divmod(i,
// per_row) and steps blockDim.x pieces, (dr, dc) = divmod(blockDim.x,
// per_row), so the copy loops divide nothing.
struct RowWalk {
  int width, per_row, r0, c0, dr, dc;
};

__device__ __forceinline__ RowWalk make_walk(int row_bytes, int width) {
  RowWalk w;
  w.width = width;
  w.per_row = row_bytes / width;
  w.r0 = threadIdx.x / w.per_row;
  w.c0 = threadIdx.x - w.r0 * w.per_row;
  w.dr = blockDim.x / w.per_row;
  w.dc = blockDim.x - w.dr * w.per_row;
  return w;
}

// Rows t0 .. t0 + nrows - 1 of one head of a time-major operand (q, v, K2's
// k: element (t, d) at base + t*dim + d), head_dim values each, into a tile
// of row stride `stride`; rows at or past seq become zeros.
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, int stride,
                                          const __nv_bfloat16* src, size_t base, int dim,
                                          int t0, int nrows, int seq, const RowWalk& w) {
  for (int r = w.r0, c = w.c0; r < nrows;) {
    const int t = t0 + r;
    const bool valid = t < seq;
    const char* from = reinterpret_cast<const char*>(
        src + base + static_cast<size_t>(valid ? t : 0) * dim) + c * w.width;
    copy_piece(reinterpret_cast<char*>(tile + r * stride) + c * w.width, from, w.width, valid);
    r += w.dr;
    c += w.dc;
    if (c >= w.per_row) {
      c -= w.per_row;
      ++r;
    }
  }
}

// Keys k0 .. k0 + kTileKeys - 1 of K1's dim-major kt (element (d, t) at
// base + d*seq + t) into a tile [head_dim][stride]; keys at or past seq
// become zeros.  width divides 2*seq, so a piece is all inside or all out.
__device__ __forceinline__ void load_kt(__nv_bfloat16* tile, int stride, const __nv_bfloat16* kt,
                                        size_t base, int k0, int seq, int head_dim, int width) {
  const int per_row = kTileKeys * 2 / width, keys = width / 2;  // powers of two
  const int shift = __ffs(per_row) - 1;
  for (int i = threadIdx.x; i < head_dim * per_row; i += blockDim.x) {
    const int d = i >> shift, c = i & (per_row - 1), t = k0 + c * keys;
    const bool valid = t < seq;
    const __nv_bfloat16* from = kt + base + static_cast<size_t>(d) * seq + (valid ? t : 0);
    copy_piece(reinterpret_cast<char*>(tile + d * stride) + c * width, from, width, valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a . b on one m16n8k16 tile: bf16 operands, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// p / sum rounded to nearest, from y = 1/sum rounded to nearest: q = p*y is
// within one ulp of p / sum, the fma gives its remainder p - q*sum exactly,
// and q + remainder*y is then the correctly rounded quotient (Markstein's
// theorem; the fast path of the IEEE division, with y computed once per row),
// for every quotient above float32's smallest normal.  div = (sum, 1/sum).
__device__ __forceinline__ float divide(float p, float2 div) {
  const float q = p * div.y;
  return fmaf(fmaf(-q, div.x, p), div.y, q);
}

// The A fragments of P.V for one pair of weights (two neighbouring keys of
// one row): K1 one part, the weights rounded to bf16; K2 three parts whose
// sum is the float32 weight (hi, then the remainders).
template <bool kHeadMajor>
__device__ __forceinline__ void weight_parts(float2 p, float2 div, uint32_t parts[3]) {
  const float w0 = divide(p.x, div), w1 = divide(p.y, div);
  const __nv_bfloat16 h0 = __float2bfloat16_rn(w0), h1 = __float2bfloat16_rn(w1);
  parts[0] = pack_bf16(h0, h1);
  if constexpr (kHeadMajor) {
    const float r0 = w0 - __bfloat162float(h0), r1 = w1 - __bfloat162float(h1);
    const __nv_bfloat16 m0 = __float2bfloat16_rn(r0), m1 = __float2bfloat16_rn(r1);
    parts[1] = pack_bf16(m0, m1);
    parts[2] = pack_bf16(__float2bfloat16_rn(r0 - __bfloat162float(m0)),
                         __float2bfloat16_rn(r1 - __bfloat162float(m1)));
  }
}

// KS = ceil(head_dim / 16): the k16 steps of Q.K^T; P.V has nv/8 <= 2*KS
// n8 tiles.  q/v (and K2's k) are copied in qv_width-byte pieces, K1's kt
// in kt_width-byte pieces.
template <bool kHeadMajor, int KS>
__global__ void __launch_bounds__(kMaxWarps * 32)
encoder_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                             int seq, int heads, int head_dim, float scale, int qv_width,
                             int kt_width) {
  // (extern shared arrays share one name space: the FMA kernel's is `smem`)
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const int warps = blockDim.x / 32;
  const Layout L = make_layout(seq, head_dim, warps);
  float* logits = reinterpret_cast<float*>(smem);                 // [rows][s]
  __nv_bfloat16* qtile = reinterpret_cast<__nv_bfloat16*>(smem);  // [rows][qs], until loaded
  unsigned char* ring = smem + L.logits;                          // kStages x L.ring bytes
  auto buffer = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(ring + (i % kStages) * L.ring);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;  // fragment row and column pair of this lane
  const int rows = warps * kWarpRows;
  const int dim = heads * head_dim;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * rows;
  const size_t base_qv = static_cast<size_t>(b) * seq * dim + static_cast<size_t>(h) * head_dim;
  const size_t base_kt = (static_cast<size_t>(b) * dim + static_cast<size_t>(h) * head_dim) * seq;
  const int ntiles = (seq + kTileKeys - 1) / kTileKeys;
  const int nv_tiles = L.nv / 8;
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * seq;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // One ring of tiles: key tiles 0 .. ntiles - 1, then value tiles ntiles ..
  // 2*ntiles - 1; ring tile i sits in buffer(i).  Tile i + kStages - 1 is
  // issued right after the barrier that opens tile i, which also certifies
  // that every warp is done with tile i - 1, the last user of that buffer.
  // Each tile is one cp.async group (past the last tile an empty one), so
  // "tile i has landed" is cp.async.wait_group kStages - 2 at the top of it.
  const RowWalk walk = make_walk(head_dim * 2, qv_width);  // q, v and K2's k
  auto load_tile = [&](int i) {
    if (i >= 2 * ntiles) {
      // nothing left: an empty group keeps the count
    } else if (i >= ntiles) {
      load_rows(buffer(i), L.vs, v, base_qv, dim, (i - ntiles) * kTileKeys, kTileKeys, seq, walk);
    } else if constexpr (kHeadMajor) {
      load_rows(buffer(i), L.ks, k, base_qv, dim, i * kTileKeys, kTileKeys, seq, walk);
    } else {
      load_kt(buffer(i), L.kts, k, base_kt, i * kTileKeys, seq, head_dim, kt_width);
    }
    cp_async_commit();
  };

  // The Q tile (zeros past seq) and the key tiles' padding dims hd..kd, as
  // zeros written here: nothing past hd is ever loaded.
  load_rows(qtile, L.qs, q, base_qv, dim, row0, rows, seq, walk);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    for (int c = head_dim; c < L.kd; ++c) qtile[r * L.qs + c] = zero;
  }
  for (int i = threadIdx.x; i < kStages * kTileKeys; i += blockDim.x) {
    __nv_bfloat16* tile = buffer(i / kTileKeys);  // key i % kTileKeys of buffer i / kTileKeys
    for (int c = head_dim; c < L.kd; ++c) {
      if constexpr (kHeadMajor) {
        tile[(i % kTileKeys) * L.ks + c] = zero;
      } else {
        tile[c * L.kts + i % kTileKeys] = zero;
      }
    }
  }
  load_tile(0);  // commits the Q tile's copies with key tile 0's
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) load_tile(i);
  cp_async_wait<kStages - 2>();
  __syncthreads();

  uint32_t qa[KS][4];  // this warp's Q rows, as A fragments, for the whole key loop
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    ldmatrix_x4(qa[s], qtile + (warp * kWarpRows + (lane & 15)) * L.qs + s * 16 + (lane >> 4) * 8);
  }

  // Q.K^T, tile by tile: logits scaled and masked into shared memory, and
  // the running max of rows g and g + 8 over this lane's keys.  The first
  // iteration's barrier also frees the Q tile, which the logits overwrite.
  float* wrow0 = logits + (warp * kWarpRows + g) * L.s;
  float* wrow1 = wrow0 + 8 * L.s;
  float mx0 = __int_as_float(0xff800000), mx1 = mx0;  // -inf
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_tile(j + kStages - 1);  // a key tile, or (at the end) the first value tiles
    // Bit 2n + e: key j*32 + n*8 + 2*qd + e lies before seq / is kept by the
    // mask (read before the products, so the loads overlap them).
    uint32_t in = 0, keep = 0;
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = j * kTileKeys + n * 8 + 2 * qd + e;
        if (t < seq) {
          in |= 1u << (2 * n + e);
          if (mrow == nullptr || mrow[t] != 0) keep |= 1u << (2 * n + e);
        }
      }
    }
    const __nv_bfloat16* tile = buffer(j);
    float acc[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int p = 0; p < kKeyTiles / 2; ++p) {  // keys p*16 .. p*16 + 15: two n8 tiles
        uint32_t bb[4];
        if constexpr (kHeadMajor) {  // tile [key][dim]
          ldmatrix_x4(bb, tile + (p * 16 + (lane & 7) + (lane >> 4) * 8) * L.ks + s * 16 +
                              ((lane >> 3) & 1) * 8);
        } else {  // tile [dim][key]
          ldmatrix_x4_trans(bb, tile + (s * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.kts +
                                    p * 16 + (lane >> 4) * 8);
        }
        mma_bf16(acc[2 * p], qa[s], bb[0], bb[1]);
        mma_bf16(acc[2 * p + 1], qa[s], bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      float l[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t bit = 1u << (2 * n + e);
        l[e] = keep & bit ? acc[n][e] * scale : kNegInf;
        l[2 + e] = keep & bit ? acc[n][2 + e] * scale : kNegInf;
        if (in & bit) {
          mx0 = fmaxf(mx0, l[e]);
          mx1 = fmaxf(mx1, l[2 + e]);
        }
      }
      const int t = j * kTileKeys + n * 8 + 2 * qd;
      *reinterpret_cast<float2*>(wrow0 + t) = make_float2(l[0], l[1]);
      *reinterpret_cast<float2*>(wrow1 + t) = make_float2(l[2], l[3]);
    }
  }

  // Exact softmax of this warp's 16 rows: the max (already taken over every
  // key, exact in any order), then exp and the sum over every key, a lane
  // taking key t of all 16 rows at once (16 independent exps); keys past seq
  // get weight 0.  The division p / sum happens as P.V reads p.
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  float m[kWarpRows], psum[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    m[r] = __shfl_sync(0xffffffffu, r < 8 ? mx0 : mx1, (r & 7) * 4);
    psum[r] = 0.f;
  }
  float* rows0 = logits + warp * kWarpRows * L.s;
  for (int t = lane; t < seq; t += 32) {
    float p[kWarpRows];  // all loads before any store: nothing orders them behind a store
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) p[r] = rows0[r * L.s + t];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      p[r] = expf(p[r] - m[r]);
      psum[r] += p[r];
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) rows0[r * L.s + t] = p[r];
  }
  for (int t = seq + lane; t < ntiles * kTileKeys; t += 32) {
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) rows0[r * L.s + t] = 0.f;
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const float s = warp_sum(psum[r]);
    if (r == g) sum0 = s;
    if (r == g + 8) sum1 = s;
  }
  const float2 div0 = make_float2(sum0, __frcp_rn(sum0)), div1 = make_float2(sum1, __frcp_rn(sum1));
  __syncwarp();

  // P.V, tile by tile over the values.
  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_tile(ntiles + j + kStages - 1);
    const __nv_bfloat16* tile = buffer(ntiles + j);
#pragma unroll
    for (int s = 0; s < kTileKeys / 16; ++s) {
      const int t = j * kTileKeys + s * 16 + 2 * qd;
      uint32_t a[4][3];  // A fragment registers 0-3, each in 1 (K1) or 3 (K2) parts
      weight_parts<kHeadMajor>(*reinterpret_cast<const float2*>(wrow0 + t), div0, a[0]);
      weight_parts<kHeadMajor>(*reinterpret_cast<const float2*>(wrow1 + t), div1, a[1]);
      weight_parts<kHeadMajor>(*reinterpret_cast<const float2*>(wrow0 + t + 8), div0, a[2]);
      weight_parts<kHeadMajor>(*reinterpret_cast<const float2*>(wrow1 + t + 8), div1, a[3]);
      const __nv_bfloat16* vrow = tile + (s * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.vs;
#pragma unroll
      for (int n = 0; n < 2 * KS; n += 2) {
        if (n >= nv_tiles) break;
        const bool pair = n + 1 < nv_tiles;
        uint32_t bb[4];
        if (pair) {
          ldmatrix_x4_trans(bb, vrow + n * 8 + (lane >> 4) * 8);
        } else {
          ldmatrix_x2_trans(bb, vrow + n * 8);
        }
#pragma unroll
        for (int part = kHeadMajor ? 2 : 0; part >= 0; --part) {  // K2: lo, mid, hi
          const uint32_t ap[4] = {a[0][part], a[1][part], a[2][part], a[3][part]};
          mma_bf16(o[n], ap, bb[0], bb[1]);
          if (pair) mma_bf16(o[n + 1], ap, bb[2], bb[3]);
        }
      }
    }
  }

  const int t0 = row0 + warp * kWarpRows + g, t1 = t0 + 8;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    if (n >= nv_tiles) break;
    const int col = n * 8 + 2 * qd;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= head_dim) continue;
      if (t0 < seq) out[base_qv + static_cast<size_t>(t0) * dim + col + e] = __float2bfloat16_rn(o[n][e]);
      if (t1 < seq) out[base_qv + static_cast<size_t>(t1) * dim + col + e] = __float2bfloat16_rn(o[n][2 + e]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

cudaError_t check_smem(size_t smem) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  return smem > static_cast<size_t>(optin) ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <bool kHeadMajor>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const void* mask, void* out,
                       int batch, int seq, int heads, int head_dim, float scale,
                       cudaStream_t stream) {
  const size_t smem = fma_shared_bytes(seq, head_dim, kHeadMajor);
  cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(encoder_attention_fma_kernel<kHeadMajor>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kFmaRows - 1) / kFmaRows, heads, batch);
  encoder_attention_fma_kernel<kHeadMajor><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), seq, heads, head_dim, scale);
  return cudaGetLastError();
}

// The widest copy piece (16, 8, 4 or 2 bytes) that divides every address:
// the pointer and the row length in bytes (which every offset is a multiple of).
int copy_width(const void* p, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int w = 16; w >= 4; w /= 2) {
    if (a % w == 0 && row_bytes % w == 0) return w;
  }
  return 2;
}

template <bool kHeadMajor, int KS>
cudaError_t launch_mma_ks(const void* q, const void* k, const void* v, const void* mask,
                          void* out, int batch, int seq, int heads, int head_dim, float scale,
                          cudaStream_t stream) {
  const int warps = choose_warps(seq, head_dim);
  if (warps == 0) return cudaErrorInvalidConfiguration;
  const size_t smem = make_layout(seq, head_dim, warps).total;
  cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  auto kernel = encoder_attention_mma_kernel<kHeadMajor, KS>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int qv_width = copy_width(q, head_dim * 2);
  const int vw = copy_width(v, head_dim * 2);
  qv_width = vw < qv_width ? vw : qv_width;
  int kt_width = 16;
  if (kHeadMajor) {
    const int kw = copy_width(k, head_dim * 2);
    qv_width = kw < qv_width ? kw : qv_width;
  } else {
    kt_width = copy_width(k, seq * 2);
  }
  const int rows = warps * kWarpRows;
  const dim3 grid((seq + rows - 1) / rows, heads, batch);
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), seq, heads, head_dim, scale, qv_width, kt_width);
  return cudaGetLastError();
}

template <bool kHeadMajor>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* mask, void* out,
                       int batch, int seq, int heads, int head_dim, float scale,
                       cudaStream_t stream) {
#define MMA_CASE(KS)                                                                        \
  case KS:                                                                                  \
    return launch_mma_ks<kHeadMajor, KS>(q, k, v, mask, out, batch, seq, heads, head_dim, \
                                         scale, stream);
  switch ((head_dim + 15) / 16) {
    MMA_CASE(1)
    MMA_CASE(2)
    MMA_CASE(3)
    MMA_CASE(4)
    MMA_CASE(5)
    MMA_CASE(6)
    MMA_CASE(7)
    MMA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MMA_CASE
}

template <bool kHeadMajor>
int run(const void* q, const void* k, const void* v, const void* mask, void* out, int batch,
        int seq, int heads, int head_dim, int dtype, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 || head_dim > kFmaThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_fma<kHeadMajor>(q, k, v, mask, out, batch, seq, heads, head_dim, scale, s);
  } else if (dtype == 1) {
    err = launch_mma<kHeadMajor>(q, k, v, mask, out, batch, seq, heads, head_dim, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32 (FMA route), 1 = bf16 (tensor-core route).  mask may be
// null (every key valid).  Each returns the CUDA error of the launch (0 on
// success); neither synchronises.

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
