// Flash attention backward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces mxnet_tpu/op/pallas/flash_attention.py:_bwd_impl, the backward
// half of the JAX package's flash_attention custom_vjp (a blockwise
// recompute over key blocks), for bfloat16 inputs, with its contract and
// numerics:
//   inputs q [b, t_q, h, d], k and v [b, t_kv, h, d], the forward's O
//   [b, t_q, h, d] and lse float32 [b*h, t_q], and dO [b, t_q, h, d];
//   outputs dQ, dK, dV bfloat16, contiguous [b, t, h, d];
//   delta = rowsum(dO * O) in float32;
//   q_s = bf16(f32(q) * scale); P = exp(q_s K^T - lse) in float32, keys
//   past t_kv and (under causal) keys above the top-left diagonal masked,
//   P = 0 on a row whose lse is -inf;
//   dV = bf16(P)^T dO, dP = dO V^T, dS = bf16(P * (dP - delta)),
//   dQ = dS K * scale, dK = dS^T q_s; every product bfloat16 in, float32
//   accumulation.
//
// What bounds it on this card: five products of 2 b h t_q t_kv d
// operations (halved under causal) at 989 TFLOP/s on the tensor cores;
// at the serving shapes (b=4, t=1024, h=12, d=64, causal) that is about
// 16 us, against about 13 us for the 44 MB it must move (PERF.md holds
// the bound and the measured time).  Only wgmma reaches that rate.
//
// What the design does about it.  Two kernels, deterministic, no
// atomics; every product is a wgmma, in one of the two forms the forward
// (flash_attention_fwd_bf16.cu) already uses: SS (both operands K-major
// from shared memory) and RS (A an accumulator fragment rounded to bf16
// in registers, B MN-major from shared memory).
// - flash_bwd_prep_bf16, half a warp a query row: delta; lse * log2(e) as
//   +inf where the row sees no key (so exp2 gives P = 0 with no branch);
//   and q_s, written once as a contiguous bf16 buffer whose head_dim is
//   zero-padded to the kernel's width, which TMA can always read.  Both
//   row statistics are padded with rows past t_q (+inf, 0).
// - flash_bwd_bf16, one grid of two kinds of block, interleaved with the
//   heaviest first, so that each kind fills the other's causal tail:
//   - a dK/dV block per (batch*head, key block): one consumer warpgroup
//     per 64 keys keeps its K and V tile in shared memory and its dK and
//     dV in registers for the whole loop; a producer warp streams 64-query
//     tiles of q_s and dO, with their row statistics, through a ring of
//     two stages by TMA.  Per tile: S^T = K q_s^T and dP^T = V dO^T (SS),
//     P^T and dS^T on the fragment (the columns are queries, so lse and
//     delta are indexed by column, from the stage), then
//     dV += bf16(P^T) dO and dK += bf16(dS^T) q_s (RS, dO and q_s
//     MN-major);
//   - a dQ block per (batch*head, query block): a consumer warpgroup per
//     64 rows keeps q_s and dO in shared memory; the producer streams
//     64-key tiles of K and V.  S = q_s K^T and dP = dO V^T (SS), dS on
//     the fragment, dQ += bf16(dS) K (RS, K MN-major); the scale is
//     applied once at the end.
// So S and dP are recomputed by both kinds: seven products where the
// function needs five, and no block writes what another writes (adding
// dQ shares in a fixed order instead, as the float32 kernel does, made
// this kernel twice as slow: PERF.md).  Head dims pad to 64 or 128
// columns: TMA zero-fills the columns past d and the rows past t.  A zero
// key scores 0, not -inf, so keys past t_kv are masked in the dQ blocks;
// in the dK/dV blocks their rows are never written.  A block of nine
// warps gets at most 168 registers a thread, so at head_dim 128 each
// block has one consumer warpgroup (255 registers): dK, dV, S^T and dP^T,
// or dQ, S and dP, fit with no spill.  A wait that never ends traps after
// about 2 s instead of hanging the card.
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int ROWS = 64;                  // rows of a box: a warpgroup's tile
constexpr int BOX = ROWS * ROW_BYTES;     // one 64 x 64 bf16 box, swizzled
constexpr int STAGES = 2;                 // ring depth of the streamed tiles
constexpr int Q_ALIGN = 128;              // row statistics padded to this
constexpr int PREP_THREADS = 256;
constexpr int MAX_TILES = 65535;          // gridDim.y limit
constexpr int STAT_BYTES = ROWS * 4;      // one tile's lse or delta

// dK/dV blocks: CONSUMERS warpgroups of 64 keys, 64-query stages
template <int D>
struct KvTile {
  static constexpr int CONSUMERS = D <= 64 ? 2 : 1;
  static constexpr int BLOCK_N = CONSUMERS * ROWS;           // keys a block
  static constexpr int THREADS = (CONSUMERS * 4 + 1) * 32;
  static constexpr int CHUNKS = D / CHUNK;
  static constexpr int KV_BYTES = CONSUMERS * CHUNKS * BOX;  // K (or V) tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int STAGE_OFF = 2 * KV_BYTES;
  static constexpr int TILE_BYTES = CHUNKS * BOX;            // q_s or dO tile
  static constexpr int STAT_OFF = 2 * TILE_BYTES;            // in a stage
  static constexpr int STAGE_TX = 2 * TILE_BYTES + 2 * STAT_BYTES;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 1024;  // 1024-aligned
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  // + 1024: the swizzled boxes need a 1024-byte aligned base
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

// dQ blocks: CONSUMERS warpgroups of 64 queries, 64-key stages
template <int D>
struct QTile {
  static constexpr int CONSUMERS = D <= 64 ? 2 : 1;
  static constexpr int BLOCK_M = CONSUMERS * ROWS;           // queries
  static constexpr int THREADS = (CONSUMERS * 4 + 1) * 32;
  static constexpr int CHUNKS = D / CHUNK;
  static constexpr int Q_BYTES = CONSUMERS * CHUNKS * BOX;   // q_s (or dO)
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int KV_BYTES = CHUNKS * BOX;              // K (or V) tile
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

// the scratch the wrapper allocates: q_s [b, t_q, h, dp] bf16, then lse
// * log2(e) and delta, each float32 [b*h, tqp]
struct Workspace {
  int dp, tqp;
  long long qs_bytes, stat_elems;
  Workspace(int b, int h, int t_q, int d)
      : dp(d <= 64 ? 64 : 128),
        tqp((t_q + Q_ALIGN - 1) / Q_ALIGN * Q_ALIGN),
        qs_bytes((static_cast<long long>(b) * t_q * h * dp * 2 + 255) / 256 *
                 256),
        stat_elems(static_cast<long long>(b) * h * tqp) {}
  long long bytes() const { return qs_bytes + 2 * stat_elems * 4; }
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;
  __nv_bfloat16* qs;
  float* lse2;     // lse * log2(e); +inf where no key is seen or t >= t_q
  float* delta;    // rowsum(dO * O); 0 where t >= t_q
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int h, t_q, t_kv, d, dp, tqp;
  long long q_sb, q_st, q_sh, o_sb, o_st, o_sh, do_sb, do_st, do_sh;
  float scale;
  int causal;
  long long rows;  // b * h * tqp
  int pairs;       // q, O and dO rows are read as 4-byte column pairs
};

// half a warp per row (bh, t) of the padded statistics, a column pair
// per lane: read as one 4-byte pair where q, O and dO allow it
__global__ void __launch_bounds__(PREP_THREADS) flash_bwd_prep_bf16(
    const Params p) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * PREP_THREADS + threadIdx.x) / 16;
  const int lane = threadIdx.x % 16;
  int t = 0, bh = 0;
  if (row < p.rows) {
    t = static_cast<int>(row % p.tqp);
    bh = static_cast<int>(row / p.tqp);
  }
  float acc = 0.f, l2 = INFINITY;
  if (row < p.rows && t < p.t_q) {
    const int bi = bh / p.h, hi = bh % p.h;
    const __nv_bfloat16* q = p.q + bi * p.q_sb + t * p.q_st + hi * p.q_sh;
    const __nv_bfloat16* o = p.o + bi * p.o_sb + t * p.o_st + hi * p.o_sh;
    const __nv_bfloat16* g =
        p.dout + bi * p.do_sb + t * p.do_st + hi * p.do_sh;
    __nv_bfloat16* qs =
        p.qs + ((static_cast<long long>(bi) * p.t_q + t) * p.h + hi) * p.dp;
    for (int c = 2 * lane; c < p.dp; c += 32) {
      float2 x = make_float2(0.f, 0.f);
      if (c < p.d) {
        float2 qv, ov, gv;
        if (p.pairs) {
          qv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + c));
          ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
          gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + c));
        } else {
          const bool two = c + 1 < p.d;
          qv = make_float2(__bfloat162float(q[c]),
                           two ? __bfloat162float(q[c + 1]) : 0.f);
          ov = make_float2(__bfloat162float(o[c]),
                           two ? __bfloat162float(o[c + 1]) : 0.f);
          gv = make_float2(__bfloat162float(g[c]),
                           two ? __bfloat162float(g[c + 1]) : 0.f);
        }
        x = make_float2(qv.x * p.scale, qv.y * p.scale);
        acc = fmaf(gv.x, ov.x, acc);
        acc = fmaf(gv.y, ov.y, acc);
      }
      *reinterpret_cast<__nv_bfloat162*>(qs + c) =
          __floats2bfloat162_rn(x.x, x.y);
    }
    const float lse = p.lse[static_cast<long long>(bh) * p.t_q + t];
    l2 = lse == -INFINITY ? INFINITY : lse * LOG2E;
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < p.rows && lane == 0) {
    p.lse2[row] = l2;
    p.delta[row] = acc;
  }
}

// stores rows r and r + 8 of m64n64 fragments (one per 64 columns),
// times mul, into a contiguous [b, t, h, d] bf16 buffer; rows past t_lim
// and columns past d are not written
template <int CHUNKS>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[CHUNKS][32],
                                           int bi, int hi, int r, int t_lim,
                                           int h, int d, int quad_col,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = r + 8 * i;
    if (t >= t_lim) continue;
    __nv_bfloat16* row =
        out + (static_cast<long long>(bi) * t_lim + t) * h * d +
        static_cast<long long>(hi) * d;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * CHUNK + 8 * j + quad_col;
        const float v0 = acc[c][4 * j + 2 * i] * mul;
        const float v1 = acc[c][4 * j + 2 * i + 1] * mul;
        if ((d & 1) == 0 && col + 1 < d) {
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < d) row[col] = __float2bfloat16_rn(v0);
          if (col + 1 < d) row[col + 1] = __float2bfloat16_rn(v1);
        }
      }
  }
}

// dK and dV of one (batch*head, key block kt), over the query tiles it
// sees
template <int D>
__device__ __forceinline__ void dkdv_block(const CUtensorMap& map_k,
                                           const CUtensorMap& map_v,
                                           const CUtensorMap& map_qs,
                                           const CUtensorMap& map_do,
                                           const Params& p, int kt) {
  using T = KvTile<D>;
  constexpr int CHUNKS = T::CHUNKS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);   // generic address
  const uint32_t kv_full = base + T::BAR_OFF;
  const uint32_t full = kv_full + 8;                 // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;          // + 8 * stage

  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int k0 = kt * T::BLOCK_N;
  const int n_qb = (p.t_q + ROWS - 1) / ROWS;
  // under causal, query tiles wholly above this key tile see none of it
  const int qb0 = p.causal ? k0 / ROWS : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::CONSUMERS * 4);    // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == T::CONSUMERS * 4) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
      for (int w = 0; w < T::CONSUMERS; ++w)
        for (int c = 0; c < CHUNKS; ++c) {
          const uint32_t off = (w * CHUNKS + c) * BOX;
          tma_load(base + off, &map_k, c * CHUNK, hi, k0 + w * ROWS, bi,
                   kv_full);
          tma_load(base + T::V_OFF + off, &map_v, c * CHUNK, hi,
                   k0 + w * ROWS, bi, kv_full);
        }
      for (int qb = qb0; qb < n_qb; ++qb) {
        const int i = qb - qb0, s = i % STAGES;
        // round i / STAGES of stage s needs the previous round released
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        const uint32_t st = base + T::STAGE_OFF + s * T::STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, T::STAGE_TX);
        for (int c = 0; c < CHUNKS; ++c) {
          tma_load(st + c * BOX, &map_qs, c * CHUNK, hi, qb * ROWS, bi,
                   full + 8 * s);
          tma_load(st + T::TILE_BYTES + c * BOX, &map_do, c * CHUNK, hi,
                   qb * ROWS, bi, full + 8 * s);
        }
        const long long at = static_cast<long long>(bh) * p.tqp + qb * ROWS;
        tma_load_flat(st + T::STAT_OFF, p.lse2 + at, STAT_BYTES,
                      full + 8 * s);
        tma_load_flat(st + T::STAT_OFF + STAT_BYTES, p.delta + at,
                      STAT_BYTES, full + 8 * s);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys wk0 + [0, 64); this thread holds rows
  // (keys) rl and rl + 8 of the warpgroup's fragments, and the columns
  // (queries) 8 j + quad_col + e
  const int wg = warp / 4;
  const int wk0 = k0 + wg * ROWS;
  const int rl = (warp % 4) * 16 + lane / 4;
  const int quad_col = 2 * (lane % 4);
  const uint32_t sk = base + wg * CHUNKS * BOX;
  const uint32_t sv = base + T::V_OFF + wg * CHUNKS * BOX;

  float s[32];                 // S^T, then P^T (float32)
  float dp[32];                // dP^T, then dS^T (float32)
  float dk[CHUNKS][32], dv[CHUNKS][32];
  uint32_t pa[16], pb[16];     // bf16(P^T), bf16(dS^T): A operands
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int qb = qb0; qb < n_qb; ++qb) {
    const int i_st = qb - qb0, st = i_st % STAGES;
    const int q0 = qb * ROWS;
    mbar_wait(full + 8 * st, (i_st / STAGES) & 1);
    __syncwarp();
    // a query tile wholly above this warpgroup's keys adds nothing
    if (!p.causal || q0 + ROWS - 1 >= wk0) {
      const uint32_t sq = base + T::STAGE_OFF + st * T::STAGE_BYTES;
      const uint32_t sdo = sq + T::TILE_BYTES;
      const float* slse2 = reinterpret_cast<const float*>(
          gbase + T::STAGE_OFF + st * T::STAGE_BYTES + T::STAT_OFF);
      const float* sdelta = slse2 + ROWS;

      // S^T = K q_s^T and dP^T = V dO^T: d / 16 steps of depth 16
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk)
          wgmma_ss_n64(s, sw128_desc(sk + c * BOX + kk * 32),
                       sw128_desc(sq + c * BOX + kk * 32), c + kk > 0);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk)
          wgmma_ss_n64(dp, sw128_desc(sv + c * BOX + kk * 32),
                       sw128_desc(sdo + c * BOX + kk * 32), c + kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);

      // element [4 j + 2 i + e] is key wk0 + rl + 8 i, query
      // q0 + 8 j + quad_col + e: P^T = exp2(S^T log2(e) - lse2[query]),
      // 0 above the causal diagonal; dS^T = P^T (dP^T - delta[query])
      const bool edge = p.causal && q0 < wk0 + ROWS - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(slse2 + 8 * j + quad_col);
        const float2 dl =
            *reinterpret_cast<const float2*>(sdelta + 8 * j + quad_col);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i + e;
            float pv = exp2f(fmaf(s[idx], LOG2E, -(e ? l2.y : l2.x)));
            if (edge && q0 + 8 * j + quad_col + e < wk0 + rl + 8 * i)
              pv = 0.f;
            s[idx] = pv;
            dp[idx] = pv * (dp[idx] - (e ? dl.y : dl.x));
          }
      }
      // the fragment of queries [16 kk, 16 kk + 16) is, element for
      // element, the A fragment of a k16 step
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        pa[n] = pack_bf16(s[2 * n], s[2 * n + 1]);
        pb[n] = pack_bf16(dp[2 * n], dp[2 * n + 1]);
      }

      // dV += P^T dO and dK += dS^T q_s: 4 steps over the tile's 64
      // queries; dO and q_s rows are queries, 16 rows = 2 atoms
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          wgmma_rs_n64(dv[c], &pa[4 * kk],
                       sw128_desc(sdo + c * BOX + kk * 2 * ATOM_BYTES));
          wgmma_rs_n64(dk[c], &pb[4 * kk],
                       sw128_desc(sq + c * BOX + kk * 2 * ATOM_BYTES));
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        pin(dv[c]);
        pin(dk[c]);
      }
      pin(pa);
      pin(pb);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  const int quad_r = wk0 + rl;
  store_rows<CHUNKS>(p.dk, dk, bi, hi, quad_r, p.t_kv, p.h, p.d, quad_col,
                     1.f);
  store_rows<CHUNKS>(p.dv, dv, bi, hi, quad_r, p.t_kv, p.h, p.d, quad_col,
                     1.f);
}

// dQ of one (batch*head, query block qt), over the key tiles it sees
template <int D>
__device__ __forceinline__ void dq_block(const CUtensorMap& map_qs,
                                         const CUtensorMap& map_do,
                                         const CUtensorMap& map_k,
                                         const CUtensorMap& map_v,
                                         const Params& p, int qt) {
  using T = QTile<D>;
  constexpr int CHUNKS = T::CHUNKS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_full = base + T::BAR_OFF;
  const uint32_t full = q_full + 8;                  // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;          // + 8 * stage

  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int q0 = qt * T::BLOCK_M;
  const int t_q = p.t_q, t_kv = p.t_kv;
  int n_kb = (t_kv + ROWS - 1) / ROWS;
  if (p.causal) n_kb = min(n_kb, (min(q0 + T::BLOCK_M, t_q) - 1) / ROWS + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == T::CONSUMERS * 4) {
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * T::Q_BYTES);
      for (int w = 0; w < T::CONSUMERS; ++w)
        for (int c = 0; c < CHUNKS; ++c) {
          const uint32_t off = (w * CHUNKS + c) * BOX;
          tma_load(base + off, &map_qs, c * CHUNK, hi, q0 + w * ROWS, bi,
                   q_full);
          tma_load(base + T::DO_OFF + off, &map_do, c * CHUNK, hi,
                   q0 + w * ROWS, bi, q_full);
        }
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) mbar_wait(empty + 8 * s, ((kb / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * T::KV_BYTES);
        for (int c = 0; c < CHUNKS; ++c) {
          tma_load(base + T::K_OFF + s * T::KV_BYTES + c * BOX, &map_k,
                   c * CHUNK, hi, kb * ROWS, bi, full + 8 * s);
          tma_load(base + T::V_OFF + s * T::KV_BYTES + c * BOX, &map_v,
                   c * CHUNK, hi, kb * ROWS, bi, full + 8 * s);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows wq0 + [0, 64); this thread holds
  // rows r and r + 8 of the fragments
  const int wg = warp / 4;
  const int wq0 = q0 + wg * ROWS;
  const int r = wq0 + (warp % 4) * 16 + lane / 4;
  const int quad_col = 2 * (lane % 4);
  const uint32_t sq = base + wg * CHUNKS * BOX;
  const uint32_t sdo = base + T::DO_OFF + wg * CHUNKS * BOX;
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = static_cast<long long>(bh) * p.tqp + r + 8 * i;
    l2[i] = p.lse2[at];
    dl[i] = p.delta[at];
  }

  float s[32];                 // S, then P
  float dp[32];                // dP, then dS
  float dq[CHUNKS][32];
  uint32_t pa[16];             // bf16(dS): the A operand of dS K
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  mbar_wait(q_full, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % STAGES;
    const int k0 = kb * ROWS;
    mbar_wait(full + 8 * st, (kb / STAGES) & 1);
    __syncwarp();
    // a key tile wholly above this warpgroup's part of the diagonal adds
    // nothing
    if (!p.causal || k0 <= wq0 + ROWS - 1) {
      const uint32_t sk = base + T::K_OFF + st * T::KV_BYTES;
      const uint32_t sv = base + T::V_OFF + st * T::KV_BYTES;

      // S = q_s K^T and dP = dO V^T
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk)
          wgmma_ss_n64(s, sw128_desc(sq + c * BOX + kk * 32),
                       sw128_desc(sk + c * BOX + kk * 32), c + kk > 0);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk)
          wgmma_ss_n64(dp, sw128_desc(sdo + c * BOX + kk * 32),
                       sw128_desc(sv + c * BOX + kk * 32), c + kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);

      // element [4 j + 2 i + e] is row r + 8 i, key k0 + 8 j + quad_col
      // + e: P = exp2(S log2(e) - lse2[row]), 0 for keys past t_kv or
      // above the causal diagonal; dS = P (dP - delta[row])
      const bool edge =
          k0 + ROWS > t_kv || (p.causal && k0 + ROWS - 1 > wq0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i + e;
            const int kj = k0 + 8 * j + quad_col + e;
            float pv = exp2f(fmaf(s[idx], LOG2E, -l2[i]));
            if (edge && (kj >= t_kv || (p.causal && r + 8 * i < kj)))
              pv = 0.f;
            dp[idx] = pv * (dp[idx] - dl[i]);
          }
#pragma unroll
      for (int n = 0; n < 16; ++n) pa[n] = pack_bf16(dp[2 * n], dp[2 * n + 1]);

      // dQ += dS K: 4 steps over the tile's 64 keys, K MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          wgmma_rs_n64(dq[c], &pa[4 * kk],
                       sw128_desc(sk + c * BOX + kk * 2 * ATOM_BYTES));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) pin(dq[c]);
      pin(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  store_rows<CHUNKS>(p.dq, dq, bi, hi, r, t_q, p.h, p.d, quad_col, p.scale);
}

// blockIdx.y interleaves the two kinds of block, heaviest first: dK/dV
// block j (it sees the most query tiles when j is small) beside dQ block
// n_qt - 1 - j (the most key tiles when it is last), then the rest of the
// kind that has more
template <int D>
__global__ void __launch_bounds__(KvTile<D>::THREADS, 1)
    flash_bwd_bf16(const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_qs,
                   const __grid_constant__ CUtensorMap map_do,
                   const Params p) {
  const int n_kt = (p.t_kv + KvTile<D>::BLOCK_N - 1) / KvTile<D>::BLOCK_N;
  const int n_qt = (p.t_q + QTile<D>::BLOCK_M - 1) / QTile<D>::BLOCK_M;
  const int m = min(n_kt, n_qt), y = blockIdx.y;
  if (y < 2 * m) {
    if (y % 2 == 0) dkdv_block<D>(map_k, map_v, map_qs, map_do, p, y / 2);
    else dq_block<D>(map_qs, map_do, map_k, map_v, p, n_qt - 1 - y / 2);
  } else if (n_kt > n_qt) {
    dkdv_block<D>(map_k, map_v, map_qs, map_do, p, y - m);
  } else {
    dq_block<D>(map_qs, map_do, map_k, map_v, p, n_qt - 1 - (y - m));
  }
}

template <int D>
int launch(const Params& p, int b, const void* k, const void* v,
           const long long* ks, const long long* vs, cudaStream_t stream) {
  using KV = KvTile<D>;
  using Q = QTile<D>;
  CUtensorMap mk, mv, mqs, mdo;
  int err = make_map(&mk, k, b, p.t_kv, p.h, p.d, ks[0], ks[1], ks[2], ROWS);
  if (err == 0)
    err = make_map(&mv, v, b, p.t_kv, p.h, p.d, vs[0], vs[1], vs[2], ROWS);
  if (err == 0)
    err = make_map(&mqs, p.qs, b, p.t_q, p.h, p.dp,
                   static_cast<long long>(p.t_q) * p.h * p.dp,
                   static_cast<long long>(p.h) * p.dp, p.dp, ROWS);
  if (err == 0)
    err = make_map(&mdo, p.dout, b, p.t_q, p.h, p.d, p.do_sb, p.do_st,
                   p.do_sh, ROWS);
  if (err != 0) return err;
  const int smem = KV::SMEM > Q::SMEM ? KV::SMEM : Q::SMEM;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int rows_per_block = PREP_THREADS / 16;
  flash_bwd_prep_bf16<<<static_cast<unsigned>((p.rows + rows_per_block - 1) /
                                              rows_per_block),
                        PREP_THREADS, 0, stream>>>(p);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  flash_bwd_bf16<D><<<dim3(b * p.h, (p.t_kv + KV::BLOCK_N - 1) / KV::BLOCK_N +
                                        (p.t_q + Q::BLOCK_M - 1) / Q::BLOCK_M),
                     KV::THREADS, smem, stream>>>(mk, mv, mqs, mdo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the scratch buffer mxtt_flash_attention_bwd_bf16 needs.
extern "C" long long mxtt_flash_attention_bwd_bf16_workspace(int b, int h,
                                                             int t_q, int d) {
  return Workspace(b, h, t_q, d).bytes();
}

// Launches the bf16 backward on `stream`; returns 0 when launched, else a
// cudaError_t, or 1000 + the CUresult of a refused tensor map.
// `strides` holds 15 element strides: (batch, time, head) of q, k, v, O
// and dO in that order.  The last dimension of each is contiguous; k, v
// and dO are read by TMA, so their base addresses and the strides of
// their dimensions longer than 1 are multiples of 16 bytes (the wrapper
// copies inputs that are not).  dq, dk, dv are contiguous [b, t, h, d]
// bf16 buffers, lse a contiguous [b*h, t_q] float32 buffer, workspace a
// 256-byte aligned buffer of the size above.
extern "C" int mxtt_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* workspace, int b, int h, int t_q, int t_kv, int d,
    const long long* st, float scale, int causal, void* stream) {
  if (b <= 0 || h <= 0 || t_q <= 0 || t_kv <= 0 || d <= 0 || d > 128 ||
      (t_q + ROWS - 1) / ROWS > MAX_TILES ||
      (t_kv + ROWS - 1) / ROWS > MAX_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  const Workspace ws(b, h, t_q, d);
  unsigned char* w = static_cast<unsigned char*>(workspace);
  float* lse2 = reinterpret_cast<float*>(w + ws.qs_bytes);
  Params p{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(o),
                 static_cast<const __nv_bfloat16*>(dout),
                 static_cast<const float*>(lse),
                 reinterpret_cast<__nv_bfloat16*>(w),
                 lse2,
                 lse2 + ws.stat_elems,
                 static_cast<__nv_bfloat16*>(dq),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv),
                 h, t_q, t_kv, d, ws.dp, ws.tqp,
                 st[0], st[1], st[2], st[9], st[10], st[11], st[12], st[13],
                 st[14], scale, causal, ws.stat_elems, 0};
  // column pairs: an even head_dim, 4-byte aligned rows
  p.pairs = d % 2 == 0 &&
            ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(o) |
              reinterpret_cast<uintptr_t>(dout)) & 3) == 0;
  const int row_strides[9] = {0, 1, 2, 9, 10, 11, 12, 13, 14};   // q, O, dO
  for (const int i : row_strides) p.pairs = p.pairs && st[i] % 2 == 0;
  const long long ks[3] = {st[3], st[4], st[5]};
  const long long vs[3] = {st[6], st[7], st[8]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64>(p, b, k, v, ks, vs, s);
  return launch<128>(p, b, k, v, ks, vs, s);
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return error_string(err);
}
