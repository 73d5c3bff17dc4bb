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
// float32: the float32-exact tensor-core kernel (`encoder_attention_f32_kernel`).
//   No TF32: float32 I/O keeps float32 products.  Each float32 operand x is
//   split into three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo =
//   bf16(x - hi - mid) (the subtractions are exact), and a product a.b runs
//   as six mma.sync m16n8k16 bf16 passes into one float32 accumulator,
//   smallest terms first: lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi (see
//   mma_f32x6); each term left out is below about 2^-24 |a.b|.  Both
//   products (Q.K^T on q and k, P.V on the float32 weights and v) take this
//   form: 989/6 = 165 TFLOP/s of float32 work, against the FMA units' 67.
//   The tensor cores' float32 accumulation is not IEEE round-to-nearest, so
//   P.V sums each 64-key tile in accumulators of its own and adds the tiles
//   in IEEE float32: the tensor cores then sum over 64 keys, not over all T
//   (on an H100, at T=2,665, this cut K2's largest error against the plain
//   version from 3.1e-6 to 7.6e-7).
//   What bounds it.  At the main path's 16 s bucket, one segment ([1, 665, 8,
//   52]), the products are 0.736 GFLOP: 0.0045 ms at 165 TFLOP/s, above the
//   4.4 MB of q, k, v and out (0.0013 ms); at the 64 s bucket (T=2,665)
//   11.82 GFLOP, 0.0717 ms.  The kernel does more: Q.K^T twice (below), hd
//   padded to the mma tiles, and two exps per logit.  What it spends its
//   time on is latency: one segment is 42 (T=665) to 167 (T=2,665) row
//   tiles per head, so a block holds one of few warps per SM sub-partition,
//   and each 64-key step of a block issues its cp.async copies, splits a
//   tile into parts and runs its products one after another (clock64 stamps
//   on an H100: about a fifth each for the copies and the split, three
//   fifths for the products).  chip_smoke.py times it beside the plain
//   version and float32 SDPA (PERF.md).
//   What the design does.  The logits are not stored: float32 rows of 16
//   queries take 64 bytes per key, which at T=2,665 would leave one warp per
//   SM.  Each warp makes two passes over the keys instead.  The first takes
//   Q.K^T tile by tile and keeps, for rows g and g + 8 over this lane's
//   keys, the running max and the sum of exp(l - max), rescaled when the max
//   grows; the four lanes of a row then combine theirs (an exchange whose
//   sums commute, so all four hold the same bits).  So the row's max and sum
//   are taken over every key before any weight is formed.  The second pass
//   computes Q.K^T again, bit for bit, forms each weight exp(l - max) / sum,
//   correctly rounded (divide), in the accumulator fragments, which are P.V's
//   A fragments, and runs P.V.  That costs 1.5x the products and keeps shared
//   memory independent of T.  One ring of kStages buffers of 64-key float32
//   tiles, filled by cp.async three entries ahead (entries: every key tile,
//   then each key tile again and its value tile); each entry is split once
//   per block, one step ahead of its use, into hi, mid and lo bf16 tiles in
//   the bf16 kernel's padded layouts (two sets), which ldmatrix reads as in
//   the bf16 kernel, so a warp spends no instructions splitting K or V.  One
//   block barrier per step.  Q's parts are read from device memory once and
//   stay in registers.  The key tiles' padded dims hd..kd are zeros written
//   once into the part sets (K1's q columns past hd, the next head's values,
//   are never read).  The key mask becomes one bit per key of the tile as the
//   tile is split.  Shared memory: 104,448 B at hd 49-64.  Blocks of 8 warps
//   (128 rows): measured on an H100, blocks of 2 or 4 warps spread one
//   segment over more SMs but lost (each block repeats the copies and the
//   splits).  A row's arithmetic does not depend on B, H or the row's place
//   in the grid.  Longest T: none from shared memory; the launch takes the
//   bytes of a kt row, 4T, as an int (copy_width), so T <= 2^29 - 64 (the
//   wrapper's max_frames).
//
// Limits: head_dim <= 128; B and H <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16), cp.async ring of K/V tiles
// (its tile copies, mma and divide serve the float32 route too)
// ---------------------------------------------------------------------------

constexpr int kTileKeys = 64;         // keys (or values) per ring tile
constexpr int kKeyTiles = kTileKeys / 8;  // n8 tiles of Q.K^T per ring tile
static_assert(kTileKeys % 16 == 0 && kTileKeys <= 128, "mask bits: one uint32 per ring tile");
constexpr int kStages = 3;            // ring buffers: kStages - 1 tiles in flight beside the one in use
static_assert(kStages >= 2, "a ring");
constexpr int kWarpRows = 16;         // query rows per warp: one m16 tile
constexpr int kMaxWarps = 8;
constexpr int kMaxHeadDim = 128;      // KS = ceil(head_dim / 16) <= 8
constexpr int kSmemPerBlock = 232448;  // Hopper: the opt-in limit of one block
constexpr int kSmemPerSM = 233472;     // Hopper: 228 KB per SM
constexpr int kSmemReserved = 1024;    // per resident block

__host__ __device__ __forceinline__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
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
template <typename E>
__device__ __forceinline__ void load_rows(E* tile, int stride, const E* src, size_t base, int dim,
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
// become zeros.  width divides seq * sizeof(E), so a piece is all inside or
// all out.
template <typename E>
__device__ __forceinline__ void load_kt(E* tile, int stride, const E* kt, size_t base, int k0,
                                        int seq, int head_dim, int width) {
  constexpr int kSize = sizeof(E);
  const int per_row = kTileKeys * kSize / width, keys = width / kSize;  // powers of two
  const int shift = __ffs(per_row) - 1;
  for (int i = threadIdx.x; i < head_dim * per_row; i += blockDim.x) {
    const int d = i >> shift, c = i & (per_row - 1), t = k0 + c * keys;
    const bool valid = t < seq;
    const E* from = kt + base + static_cast<size_t>(d) * seq + (valid ? t : 0);
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
  // (extern shared arrays share one name space: the float32 kernel's is `f32_smem`)
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
// float32 route: float32-exact products on the bf16 tensor cores
// ---------------------------------------------------------------------------

constexpr int kF32Group = 4;  // n8 tiles whose six mma passes interleave

// Shared memory of the float32 kernel: kStages ring buffers of float32
// tiles as cp.async lands them (K1's keys [kd][kTileKeys], K2's
// [kTileKeys][kd], the values [kTileKeys][nv]), and two sets of three bf16
// part tiles (hi, mid, lo) in the bf16 kernel's padded layouts (make_layout:
// [kd][kts], [kTileKeys][ks], [kTileKeys][vs]), which ldmatrix reads.
// Nothing depends on T.
struct F32Layout {
  Layout p;    // strides of the part tiles (p.ring: bytes of one part tile)
  int ring;    // bytes of one float32 ring buffer
  int parts;   // byte offset of the part tiles
  int total;   // bytes of the block
};

__host__ __device__ __forceinline__ F32Layout make_f32_layout(int head_dim) {
  F32Layout L;
  L.p = make_layout(0, head_dim, 1);
  L.ring = 4 * kTileKeys * L.p.kd;  // kd >= nv
  L.parts = kStages * L.ring;
  L.total = L.parts + 2 * 3 * L.p.ring;
  return L;
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two neighbouring float32 values as the three bf16 parts of each, packed
// (the first value in the low half): p[0] = hi = bf16(x), p[1] = mid =
// bf16(x - hi), p[2] = lo = bf16(x - hi - mid).  Both subtractions are
// exact, so hi + mid + lo is x to within about 2^-27 |x|.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t p[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hi);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(mid);
  p[0] = bf162_bits(hi);
  p[1] = bf162_bits(mid);
  p[2] = bf162_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// c[n] += a . b[n] for the first `count` of kF32Group m16n8k16 tiles, to
// float32 accuracy: a's A fragment registers [reg][part] and each b[n]'s
// two B registers [part][reg], in three parts (split3), as six bf16 passes
// into one float32 accumulator per tile, smallest terms first: lo.hi,
// hi.lo, mid.mid, mid.hi, hi.mid, hi.hi.  The three terms left out (lo.lo,
// lo.mid, mid.lo) are each below about 2^-24 |a.b|.  Each pass runs over
// all the tiles before the next, so no mma waits on the one just issued.
__device__ __forceinline__ void mma_f32x6(float (*c)[4], const uint32_t a[4][3],
                                          const uint32_t (*b)[3][2], int count) {
  auto pass = [&](int pa, int pb) {  // part of a, part of b: 0 hi, 1 mid, 2 lo
    const uint32_t ap[4] = {a[0][pa], a[1][pa], a[2][pa], a[3][pa]};
#pragma unroll
    for (int n = 0; n < kF32Group; ++n) {
      if (n < count) mma_bf16(c[n], ap, b[n][pb][0], b[n][pb][1]);
    }
  };
  pass(2, 0);
  pass(0, 2);
  pass(1, 1);
  pass(1, 0);
  pass(0, 1);
  pass(0, 0);
}

// (m, s) of rows g or g + 8 from this lane and from lane ^ mask combined:
// the larger max, and both sums rescaled to it.  The two lanes add the same
// two terms, so both hold the same bits; a lane that saw no key (max -inf,
// sum 0) adds 0.
__device__ __forceinline__ void combine_stats(float& m, float& s, int mask) {
  const float mo = __shfl_xor_sync(0xffffffffu, m, mask);
  const float so = __shfl_xor_sync(0xffffffffu, s, mask);
  const float mm = fmaxf(m, mo);
  s = (m == mm ? s : s * expf(m - mm)) + (mo == mm ? so : so * expf(mo - mm));
  m = mm;
}

// The pairs of a float32 tile (rows of `stride` floats, `w.per_row` pairs
// each, as walked by w: make_walk with 8-byte pieces) split into three bf16
// part tiles (rows of `pstride`, `part` elements apart); a value at column
// `cols` or past becomes 0.  Four pairs at a time, loads first.
__device__ __forceinline__ void split_tile(const float* src, int stride, __nv_bfloat16* dst,
                                           int pstride, int part, int rows, int cols,
                                           const RowWalk& w) {
  for (int r = w.r0, c = w.c0; r < rows;) {
    int at[4];
    float2 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      at[u] = -1;
      if (r < rows) {
        at[u] = r * pstride + 2 * c;
        x[u] = *reinterpret_cast<const float2*>(src + r * stride + 2 * c);
        if (2 * c + 1 >= cols) x[u].y = 0.f;
      }
      r += w.dr;
      c += w.dc;
      if (c >= w.per_row) {
        c -= w.per_row;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (at[u] < 0) continue;
      uint32_t p[3];
      split3(x[u].x, x[u].y, p);
      uint32_t* to = reinterpret_cast<uint32_t*>(dst + at[u]);
      to[0] = p[0];
      to[part / 2] = p[1];
      to[part] = p[2];
    }
  }
}

// KS = ceil(head_dim / 16): the k16 steps of Q.K^T; P.V has nv/8 <= 2*KS
// n8 tiles.  v (and K2's k) are copied in qv_width-byte pieces, K1's kt in
// kt_width-byte pieces; q is read straight into registers.
template <bool kHeadMajor, int KS>
__global__ void __launch_bounds__(kMaxWarps * 32)
encoder_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const uint8_t* __restrict__ mask,
                             float* __restrict__ out, int seq, int heads, int head_dim,
                             float scale, int qv_width, int kt_width) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  __shared__ uint32_t keep_bits[2][kTileKeys / 32];  // per part set: key kept by the mask
  const F32Layout L = make_f32_layout(head_dim);
  const Layout& P = L.p;
  const int part = P.ring / 2;  // elements from one part tile to the next
  auto ring = [&](int i) { return reinterpret_cast<float*>(f32_smem + (i % kStages) * L.ring); };
  auto parts = [&](int i) {  // the hi tile of part set i % 2; mid at + part, lo at + 2 * part
    return reinterpret_cast<__nv_bfloat16*>(f32_smem + L.parts + (i & 1) * 3 * P.ring);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;  // fragment row and column pair of this lane
  const int rows = (blockDim.x >> 5) * kWarpRows;
  const int dim = heads * head_dim;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * rows;
  const size_t base_qv = static_cast<size_t>(b) * seq * dim + static_cast<size_t>(h) * head_dim;
  const size_t base_kt = (static_cast<size_t>(b) * dim + static_cast<size_t>(h) * head_dim) * seq;
  const int ntiles = (seq + kTileKeys - 1) / kTileKeys;
  const int nv_tiles = P.nv / 8;
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * seq;

  // The entries of one ring: 0 .. ntiles - 1 are the key tiles of the
  // statistics pass; ntiles + 2j is key tile j again and ntiles + 2j + 1
  // value tile j, for the output pass.  Entry i lands (cp.async, one group
  // each, past the last an empty one) in ring(i), three entries ahead; it is
  // split into part set i % 2 one step ahead of its use.  So step i reads
  // part set i % 2 while entry i + 1 is split and entries i + 2, i + 3 are
  // in flight, with one block barrier per step: it certifies that entry i +
  // 1 has landed, that part set i % 2 is written, and that every warp is
  // done with part set (i + 1) % 2 and ring(i).
  auto is_values = [&](int i) { return i >= ntiles && ((i - ntiles) & 1); };
  auto tile_of = [&](int i) { return i < ntiles ? i : (i - ntiles) >> 1; };
  const RowWalk copy_walk = make_walk(head_dim * 4, qv_width);  // v and K2's k rows
  auto load_entry = [&](int i) {
    if (i < 3 * ntiles) {
      float* tile = ring(i);
      const int t0 = tile_of(i) * kTileKeys;
      if (is_values(i)) {
        load_rows(tile, P.nv, v, base_qv, dim, t0, kTileKeys, seq, copy_walk);
      } else if constexpr (kHeadMajor) {  // [key][kd]
        load_rows(tile, P.kd, k, base_qv, dim, t0, kTileKeys, seq, copy_walk);
      } else {  // [kd][key]
        load_kt(tile, kTileKeys, k, base_kt, t0, seq, head_dim, kt_width);
      }
    }
    cp_async_commit();
  };
  const int hd2 = round_up(head_dim, 2);
  const RowWalk row_walk = make_walk(hd2 * 4, 8);  // K2's keys and the values: pairs of dims
  const RowWalk kt_walk = make_walk(kTileKeys * 4, 8);  // K1's keys: pairs of keys
  auto split_entry = [&](int i) {
    if (i >= 3 * ntiles) return;
    const float* src = ring(i);
    __nv_bfloat16* dst = parts(i);
    if (is_values(i)) {
      split_tile(src, P.nv, dst, P.vs, part, kTileKeys, head_dim, row_walk);
      return;
    }
    if constexpr (kHeadMajor) {
      split_tile(src, P.kd, dst, P.ks, part, kTileKeys, head_dim, row_walk);
    } else {
      split_tile(src, kTileKeys, dst, P.kts, part, head_dim, kTileKeys, kt_walk);
    }
    const int t0 = tile_of(i) * kTileKeys;
    for (int k0 = warp * 32; k0 < kTileKeys; k0 += blockDim.x) {  // warp-uniform
      const int t = t0 + k0 + lane;
      const bool kept = t < seq && (mrow == nullptr || mrow[t] != 0);
      const uint32_t bits = __ballot_sync(0xffffffffu, kept);
      if (lane == 0) keep_bits[i & 1][k0 / 32] = bits;
    }
  };

#pragma unroll
  for (int i = 0; i < kStages; ++i) load_entry(i);
  // Zeros in both part sets: the key tiles' dims hd..kd are never written
  // after this (the value tiles, in the output pass, take the part set that
  // its key tiles do not).
  for (int i = threadIdx.x; i < 2 * 3 * P.ring / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(f32_smem + L.parts)[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // This warp's Q rows as A fragments in three parts each, for both passes
  // (zeros past seq and past hd), read while the first tiles land.
  const int t0 = row0 + warp * kWarpRows + g, t1 = t0 + 8;
  auto qval = [&](int t, int c) {
    return t < seq && c < head_dim ? q[base_qv + static_cast<size_t>(t) * dim + c] : 0.f;
  };
  uint32_t qa[KS][4][3];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + 2 * qd;
    split3(qval(t0, c), qval(t0, c + 1), qa[s][0]);
    split3(qval(t1, c), qval(t1, c + 1), qa[s][1]);
    split3(qval(t0, c + 8), qval(t0, c + 9), qa[s][2]);
    split3(qval(t1, c + 8), qval(t1, c + 9), qa[s][3]);
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  split_entry(0);

  // The scaled, masked logits of the key tile in part set i for rows g
  // (acc[n][0, 1]) and g + 8 (acc[n][2, 3]) at keys n*8 + 2*qd + e of tile
  // j; `in` has bit 2n + e set where that key lies before seq.  Bit for bit
  // the same in both passes.
  auto logits = [&](int i, int j, float (&acc)[kKeyTiles][4], uint32_t& in) {
    const __nv_bfloat16* tile = parts(i);
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int n0 = 0; n0 < kKeyTiles; n0 += kF32Group) {
        uint32_t bp[kF32Group][3][2];
#pragma unroll
        for (int pp = 0; pp < kF32Group / 2; ++pp) {  // keys (n0/2 + pp)*16 ..: two n8 tiles
          const int p16 = n0 / 2 + pp;
#pragma unroll
          for (int pt = 0; pt < 3; ++pt) {
            uint32_t bb[4];
            if constexpr (kHeadMajor) {  // tile [key][dim]
              ldmatrix_x4(bb, tile + pt * part + (p16 * 16 + (lane & 7) + (lane >> 4) * 8) * P.ks +
                                  s * 16 + ((lane >> 3) & 1) * 8);
            } else {  // tile [dim][key]
              ldmatrix_x4_trans(bb, tile + pt * part +
                                        (s * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P.kts +
                                        p16 * 16 + (lane >> 4) * 8);
            }
            bp[2 * pp][pt][0] = bb[0];
            bp[2 * pp][pt][1] = bb[1];
            bp[2 * pp + 1][pt][0] = bb[2];
            bp[2 * pp + 1][pt][1] = bb[3];
          }
        }
        mma_f32x6(acc + n0, qa[s], bp, kF32Group);
      }
    }
    const uint32_t kept0 = keep_bits[i & 1][0], kept1 = keep_bits[i & 1][1];
    in = 0;
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = n * 8 + 2 * qd + e;
        if (j * kTileKeys + key < seq) in |= 1u << (2 * n + e);
        const bool kept = ((key < 32 ? kept0 : kept1) >> (key & 31)) & 1u;
        acc[n][e] = kept ? acc[n][e] * scale : kNegInf;
        acc[n][2 + e] = kept ? acc[n][2 + e] * scale : kNegInf;
      }
    }
  };

  // Per row, over this lane's keys: the max and the sum of exp(l - max),
  // rescaled when a tile raises the max (statistics pass); then over the
  // row's four lanes.  The weights exp(l - max) / sum of the key tile just
  // multiplied (output pass), and the output accumulators.
  const float neg_inf = __int_as_float(0xff800000);
  float m0 = neg_inf, m1 = neg_inf, s0 = 0.f, s1 = 0.f;
  float2 div0, div1;
  float w[kKeyTiles][4];
  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int i = 0; i < 3 * ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_entry(i + kStages);
    split_entry(i + 1);
    const int j = tile_of(i);
    if (i < ntiles) {  // statistics pass
      uint32_t in;
      logits(i, j, w, in);
      float x0 = neg_inf, x1 = neg_inf;
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (in & (1u << (2 * n + e))) {
            x0 = fmaxf(x0, w[n][e]);
            x1 = fmaxf(x1, w[n][2 + e]);
          }
        }
      }
      if (x0 > m0) {
        s0 *= expf(m0 - x0);
        m0 = x0;
      }
      if (x1 > m1) {
        s1 *= expf(m1 - x1);
        m1 = x1;
      }
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (in & (1u << (2 * n + e))) {
            s0 += expf(w[n][e] - m0);
            s1 += expf(w[n][2 + e] - m1);
          }
        }
      }
      if (i == ntiles - 1) {
        combine_stats(m0, s0, 1);
        combine_stats(m0, s0, 2);
        combine_stats(m1, s1, 1);
        combine_stats(m1, s1, 2);
        div0 = make_float2(s0, __frcp_rn(s0));
        div1 = make_float2(s1, __frcp_rn(s1));
      }
    } else if (!is_values(i)) {  // output pass: the weights of key tile j (0 past seq)
      uint32_t in;
      logits(i, j, w, in);
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool inside = in & (1u << (2 * n + e));
          w[n][e] = inside ? divide(expf(w[n][e] - m0), div0) : 0.f;
          w[n][2 + e] = inside ? divide(expf(w[n][2 + e] - m1), div1) : 0.f;
        }
      }
    } else {  // output pass: P.V over value tile j, the weights' fragments as A
      const __nv_bfloat16* tile = parts(i);
      // This tile's share in its own accumulators, added to o in IEEE
      // float32: the tensor cores' accumulation (not round-to-nearest) then
      // runs over 64 keys at a time, not over all T.
      float ot[round_up(2 * KS, kF32Group)][4];  // whole groups, as mma_f32x6 takes them
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) ot[n][0] = ot[n][1] = ot[n][2] = ot[n][3] = 0.f;
#pragma unroll
      for (int s = 0; s < kTileKeys / 16; ++s) {  // keys s*16 .. s*16 + 15 of the tile
        uint32_t a[4][3];
        split3(w[2 * s][0], w[2 * s][1], a[0]);
        split3(w[2 * s][2], w[2 * s][3], a[1]);
        split3(w[2 * s + 1][0], w[2 * s + 1][1], a[2]);
        split3(w[2 * s + 1][2], w[2 * s + 1][3], a[3]);
        const __nv_bfloat16* vrow = tile + (s * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P.vs;
#pragma unroll
        for (int n0 = 0; n0 < 2 * KS; n0 += kF32Group) {
          if (n0 >= nv_tiles) break;
          uint32_t bp[kF32Group][3][2];
#pragma unroll
          for (int n = n0; n < n0 + kF32Group; n += 2) {
            if (n >= nv_tiles) break;
#pragma unroll
            for (int pt = 0; pt < 3; ++pt) {
              uint32_t bb[4];
              if (n + 1 < nv_tiles) {
                ldmatrix_x4_trans(bb, vrow + pt * part + n * 8 + (lane >> 4) * 8);
              } else {
                ldmatrix_x2_trans(bb, vrow + pt * part + n * 8);
                bb[2] = bb[3] = 0u;
              }
              bp[n - n0][pt][0] = bb[0];
              bp[n - n0][pt][1] = bb[1];
              bp[n - n0 + 1][pt][0] = bb[2];
              bp[n - n0 + 1][pt][1] = bb[3];
            }
          }
          mma_f32x6(ot + n0, a, bp, nv_tiles - n0);
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        o[n][0] += ot[n][0];
        o[n][1] += ot[n][1];
        o[n][2] += ot[n][2];
        o[n][3] += ot[n][3];
      }
    }
  }

#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    if (n >= nv_tiles) break;
    const int col = n * 8 + 2 * qd;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= head_dim) continue;
      if (t0 < seq) out[base_qv + static_cast<size_t>(t0) * dim + col + e] = o[n][e];
      if (t1 < seq) out[base_qv + static_cast<size_t>(t1) * dim + col + e] = o[n][2 + e];
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

template <bool kHeadMajor, int KS>
cudaError_t launch_f32_ks(const void* q, const void* k, const void* v, const void* mask,
                          void* out, int batch, int seq, int heads, int head_dim, float scale,
                          cudaStream_t stream) {
  const size_t smem = make_f32_layout(head_dim).total;
  cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  auto kernel = encoder_attention_f32_kernel<kHeadMajor, KS>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int qv_width = copy_width(v, head_dim * 4);
  int kt_width = 16;
  if (kHeadMajor) {
    const int kw = copy_width(k, head_dim * 4);
    qv_width = kw < qv_width ? kw : qv_width;
  } else {
    kt_width = copy_width(k, seq * 4);
  }
  const int rows = kMaxWarps * kWarpRows;  // blocks of 8 warps: see the header
  const dim3 grid((seq + rows - 1) / rows, heads, batch);
  kernel<<<grid, kMaxWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), seq, heads, head_dim, scale,
      qv_width, kt_width);
  return cudaGetLastError();
}

// dtype 0 (float32) or 1 (bf16), at KS = ceil(head_dim / 16).
template <bool kHeadMajor>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* mask,
                   void* out, int batch, int seq, int heads, int head_dim, float scale,
                   cudaStream_t stream) {
#define KS_CASE(KS)                                                                           \
  case KS:                                                                                    \
    return dtype == 0 ? launch_f32_ks<kHeadMajor, KS>(q, k, v, mask, out, batch, seq, heads, \
                                                      head_dim, scale, stream)               \
                      : launch_mma_ks<kHeadMajor, KS>(q, k, v, mask, out, batch, seq, heads, \
                                                      head_dim, scale, stream);
  switch ((head_dim + 15) / 16) {
    KS_CASE(1)
    KS_CASE(2)
    KS_CASE(3)
    KS_CASE(4)
    KS_CASE(5)
    KS_CASE(6)
    KS_CASE(7)
    KS_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef KS_CASE
}

template <bool kHeadMajor>
int run(const void* q, const void* k, const void* v, const void* mask, void* out, int batch,
        int seq, int heads, int head_dim, int dtype, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 || head_dim > kMaxHeadDim ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<kHeadMajor>(dtype, q, k, v, mask, out, batch, seq, heads,
                                             head_dim, scale, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dtype: 0 = float32, 1 = bf16 (both on the tensor cores).  mask may be
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
