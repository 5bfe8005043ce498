// Flash attention forward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel mxnet_tpu/op/pallas/flash_attention.py:
// _fwd_kernel (launched by _fwd_impl, wrapped by flash_attention) for
// bfloat16 inputs, with its semantics:
//   O = softmax(scale * Q K^T + mask) V and lse = per-row logsumexp,
//   q [b, t_q, h, d], k and v [b, t_kv, h, d], O bfloat16 [b, t_q, h, d],
//   lse float32 [b*h, t_q];
//   bfloat16 products accumulated in float32; the scale applied to the
//   float32 scores; P rounded to bfloat16 before P V; keys past t_kv
//   masked; the causal mask top-left aligned (q_pos >= k_pos); a row with
//   l == 0 gives O = 0 and lse = -inf.
//
// What bounds it on this card: at the serving shapes (b=4, t=1024, h=12,
// d=64, causal) the work is about 6.4 GFLOP against 25 MB of q, k, v, o and
// lse, some 250 flop per byte: just below the 295 at which the bf16 tensor
// cores (989 TFLOP/s) and not device memory (3.35 TB/s) set the pace, so
// both bounds are near (PERF.md holds the bound and the measured time).
// Only wgmma reaches that arithmetic rate, and only if the tensor cores
// never wait on loads or on the softmax.
//
// What the design does about it.  One block per (batch*head, 128-row Q
// tile), heaviest causal tiles first, with three roles:
// - one producer warp, whose one thread loads the Q tile once by TMA and
//   then streams K and V tiles into a ring of two stages in shared memory,
//   with a full and an empty mbarrier per stage.  It never issues a tile
//   wholly above the causal diagonal.  Tensor maps (built on the host per
//   call) describe the [b, t, h, d] views with their real strides, so the
//   q, k, v slices of one fused QKV projection are read without a copy;
//   the 128-byte swizzle they write is what wgmma reads without bank
//   conflicts;
// - two consumer warpgroups of 64 query rows each.  S = Q K^T is one
//   wgmma chain from shared memory (bf16 in, f32 accumulate); the online
//   softmax runs on the accumulator fragment (a row's max and sum are
//   quad shuffles, exp2 with scale*log2(e) folded in); P is rounded to
//   bf16 in registers, where its fragment is already the A operand of the
//   P V wgmma, whose B is V from shared memory, MN-major.  O is rescaled
//   in registers.  Each stage is released to the producer once both of
//   its products have completed.  The two warpgroups interleave on the
//   tensor cores: while one runs its softmax the other's products run.
// Head dims pad to 64 or 128 columns: TMA zero-fills the columns past d
// and the rows past t, and the kernel masks keys past t_kv (a zero key
// scores 0, not -inf).  A wait that never ends traps instead of hanging
// the card.
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int WG_ROWS = 64;                    // query rows per consumer
constexpr int CONSUMERS = 2;                   // consumer warpgroups
constexpr int BLOCK_M = CONSUMERS * WG_ROWS;   // query rows per block
constexpr int PRODUCER_WARP = CONSUMERS * 4;
constexpr int THREADS = (CONSUMERS * 4 + 1) * 32;
constexpr int STAGES = 2;                      // K/V ring depth
constexpr int MAX_Q_TILES = 65535;             // gridDim.y limit

template <int D>
struct Tile {
  static constexpr int BLOCK_N = D <= 64 ? 128 : 64;   // keys per K/V tile
  static constexpr int CHUNKS = D / CHUNK;
  static constexpr int Q_BOX = WG_ROWS * ROW_BYTES;
  static constexpr int KV_BOX = BLOCK_N * ROW_BYTES;
  static constexpr int Q_BYTES = CONSUMERS * CHUNKS * Q_BOX;
  static constexpr int KV_BYTES = CHUNKS * KV_BOX;     // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // + 1024: the swizzled boxes need a 1024-byte aligned base
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

struct Params {
  __nv_bfloat16* o;
  float* lse;
  int h, t_q, t_kv, d;
  float scale_log2;     // scale * log2(e)
  int causal;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const Params p) {
  using T = Tile<D>;
  constexpr int BLOCK_N = T::BLOCK_N;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_full = base + T::BAR_OFF;
  const uint32_t full = q_full + 8;                  // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;          // + 8 * stage

  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;   // heaviest first
  const int t_q = p.t_q, t_kv = p.t_kv;
  int n_kb = (t_kv + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) n_kb = min(n_kb, (min(q0 + BLOCK_M, t_q) - 1) / BLOCK_N + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);       // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        for (int c = 0; c < T::CHUNKS; ++c)
          tma_load(base + (w * T::CHUNKS + c) * T::Q_BOX, &map_q, c * CHUNK,
                   hi, q0 + w * WG_ROWS, bi, q_full);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % STAGES;
        // round kb / STAGES of stage s needs the previous round released
        if (kb >= STAGES) mbar_wait(empty + 8 * s, ((kb / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * T::KV_BYTES);
        for (int c = 0; c < T::CHUNKS; ++c) {
          tma_load(base + T::K_OFF + s * T::KV_BYTES + c * T::KV_BOX, &map_k,
                   c * CHUNK, hi, kb * BLOCK_N, bi, full + 8 * s);
          tma_load(base + T::V_OFF + s * T::KV_BYTES + c * T::KV_BOX, &map_v,
                   c * CHUNK, hi, kb * BLOCK_N, bi, full + 8 * s);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows wq0 + [0, 64); this thread holds
  // rows r and r + 8 of the accumulator fragments
  const int wg = warp / 4;
  const int wq0 = q0 + wg * WG_ROWS;
  const int r = wq0 + (warp % 4) * 16 + lane / 4;
  const int quad_col = 2 * (lane % 4);
  const uint32_t sq = base + wg * T::CHUNKS * T::Q_BOX;
  const float sl2 = p.scale_log2;

  float s[BLOCK_N / 2];            // S, then P, as m64nBLOCK_N fragments
  float o[T::CHUNKS][32];          // O, one m64n64 fragment per 64 columns
  uint32_t pa[BLOCK_N / 4];        // P in bf16: the A operand of P V
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int c = 0; c < T::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

  mbar_wait(q_full, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % STAGES;
    const int k0 = kb * BLOCK_N;
    mbar_wait(full + 8 * st, (kb / STAGES) & 1);
    __syncwarp();
    // a tile wholly above this warpgroup's part of the diagonal adds nothing
    if (!p.causal || k0 <= wq0 + WG_ROWS - 1) {
      const uint32_t sk = base + T::K_OFF + st * T::KV_BYTES;
      const uint32_t sv = base + T::V_OFF + st * T::KV_BYTES;

      // S = Q K^T: d / 16 steps of depth 16 (32 bytes along a swizzled row)
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c)
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk) {
          const uint64_t da = sw128_desc(sq + c * T::Q_BOX + kk * 32);
          const uint64_t db = sw128_desc(sk + c * T::KV_BOX + kk * 32);
          if constexpr (BLOCK_N == 128)
            wgmma_ss_n128(s, da, db, c + kk > 0);
          else
            wgmma_ss_n64(s, da, db, c + kk > 0);
        }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      // x = s * scale * log2(e), -inf where masked; fragment element
      // s[4 j + 2 i + e] is row r + 8 i, key k0 + 8 j + quad_col + e
      const bool edge =
          k0 + BLOCK_N > t_kv || (p.causal && k0 + BLOCK_N - 1 > wq0);
#pragma unroll
      for (int j = 0; j < BLOCK_N / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = k0 + 8 * j + quad_col + e;
            float& x = s[4 * j + 2 * i + e];
            x *= sl2;
            if (edge && (kj >= t_kv || (p.causal && r + 8 * i < kj)))
              x = -INFINITY;
          }

      // online softmax in the log2 domain
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BLOCK_N / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = quad_max(mx);
        const float m_new = fmaxf(m[i], mx);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float corr = m[i] == -INFINITY ? 0.f : exp2f(m[i] - m_safe);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BLOCK_N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * i + e];
            x = exp2f(x - m_safe);
            sum += x;
          }
        // this thread's part of the row sum; the quad adds up at the end
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[c][4 * j + 2 * i] *= corr;
            o[c][4 * j + 2 * i + 1] *= corr;
          }
      }

      // the accumulator fragment of keys [16 kk, 16 kk + 16) is, element
      // for element, the A fragment of a k16 step: round it to bf16 pairs
#pragma unroll
      for (int i = 0; i < BLOCK_N / 4; ++i)
        pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

      // O += P V: BLOCK_N / 16 steps; V rows are keys, 16 rows = 2 atoms
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk)
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c)
          wgmma_rs_n64(o[c], &pa[4 * kk],
                       sw128_desc(sv + c * T::KV_BOX + kk * 2 * ATOM_BYTES));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c) pin(o[c]);
      pin(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // epilogue: O / l in bf16 through the row stride h * d, and lse
  const int d = p.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_row = quad_sum(l[i]);
    const int qi = r + 8 * i;
    if (qi >= t_q) continue;
    const float inv = l_row == 0.f ? 0.f : 1.f / l_row;
    __nv_bfloat16* orow =
        p.o + (static_cast<long long>(bi) * t_q + qi) * p.h * d +
        static_cast<long long>(hi) * d;
#pragma unroll
    for (int c = 0; c < T::CHUNKS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * CHUNK + 8 * j + quad_col;
        const float v0 = o[c][4 * j + 2 * i] * inv;
        const float v1 = o[c][4 * j + 2 * i + 1] * inv;
        if ((d & 1) == 0 && col + 1 < d) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < d) orow[col] = __float2bfloat16_rn(v0);
          if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    if (lane % 4 == 0)
      p.lse[static_cast<long long>(bh) * t_q + qi] =
          m[i] == -INFINITY ? -INFINITY
                            : (m[i] + log2f(l_row)) * 0.69314718055994531f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int b, const long long* qs, const long long* ks,
           const long long* vs, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, b, p.t_q, p.h, p.d, qs[0], qs[1], qs[2],
                     WG_ROWS);
  // with no keys nothing is loaded from k and v: describe q in their place
  if (p.t_kv == 0) k = v = q, ks = vs = qs;
  const int t_kv = p.t_kv == 0 ? p.t_q : p.t_kv;
  if (err == 0)
    err = make_map(&mk, k, b, t_kv, p.h, p.d, ks[0], ks[1], ks[2],
                   T::BLOCK_N);
  if (err == 0)
    err = make_map(&mv, v, b, t_kv, p.h, p.d, vs[0], vs[1], vs[2],
                   T::BLOCK_N);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(b * p.h, (p.t_q + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_bf16<D><<<grid, THREADS, T::SMEM, stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the bf16 forward on `stream`; returns 0 when launched, else a
// cudaError_t, or 1000 + the CUresult of a refused tensor map.
// Strides are in elements; the last dimension of q, k and v is
// contiguous, their base addresses and the strides of dimensions longer
// than 1 are multiples of 16 bytes (the wrapper copies inputs that are
// not).  o is a contiguous [b, t_q, h, d] bf16 buffer, lse a contiguous
// [b*h, t_q] f32 buffer.
extern "C" int mxtt_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int h, int t_q, int t_kv, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale, int causal,
    void* stream) {
  if (b <= 0 || h <= 0 || t_q <= 0 || t_kv < 0 || d <= 0 || d > 128 ||
      (t_q + BLOCK_M - 1) / BLOCK_M > MAX_Q_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                 h, t_q, t_kv, d, scale * 1.44269504088896341f, causal};
  const long long qs[3] = {q_sb, q_st, q_sh}, ks[3] = {k_sb, k_st, k_sh},
                  vs[3] = {v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64>(q, k, v, p, b, qs, ks, vs, s);
  return launch<128>(q, k, v, p, b, qs, ks, vs, s);
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return error_string(err);
}
