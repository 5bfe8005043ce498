// Flash attention backward in float32 on the CUDA cores (sm_90a).
//
// Replaces mxnet_tpu/op/pallas/flash_attention.py:_bwd_impl, the backward
// half of the JAX package's flash_attention custom_vjp (a blockwise
// recompute over key blocks), for float32 inputs, with its contract:
//   inputs q [b, t_q, h, d], k and v [b, t_kv, h, d], the forward's O
//   [b, t_q, h, d] and lse float32 [b*h, t_q], and dO [b, t_q, h, d];
//   outputs dQ, dK, dV float32, contiguous [b, t, h, d];
//   delta = rowsum(dO * O);
//   P = exp(scale q K^T - lse), keys past t_kv and (under causal) keys
//   above the top-left diagonal masked, P = 0 on a row whose lse is -inf;
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - delta), dQ = dS K * scale,
//   dK = dS^T q * scale.  Every product is true float32: the training
//   tier holds gradients to 1e-4 of the CPU, which TF32 would break.
//   The scale multiplies the float32 scores and the finished dK and dQ
//   rather than q, so q streams into shared memory as it is.
//
// What bounds it on this card: five products of 2 b h t_q t_kv d
// operations (halved under causal) at 67 TFLOP/s on the CUDA cores; at
// the serving shapes (b=4, t=1024, h=12, d=64, causal) that arithmetic,
// not device memory, is the bound (PERF.md holds the bound and the time).
// To come near it the SMs must issue little besides fused multiply-adds,
// fed from shared memory, with loads that never stall them.
//
// What the design does about it.  Two kernels: flash_bwd_delta_f32 (one
// warp a row), then flash_bwd_f32, one block per (batch*head, 64-key
// tile) that keeps its K and V tile in shared memory and loops over the
// query tiles it sees.  For each it computes S and dP once and all three
// gradients from them: dK and dV into registers, and the tile's share of
// dQ, dS K, which it adds into dQ itself.  So the card does the five
// products the function needs, not seven.  The shares of one query tile
// are added in the order of key tiles: a counter per (batch*head, query
// tile) gives each key tile its turn, the first share is stored, the
// others are added to what the earlier turns left (read from L2), and
// the last turn writes dQ times the scale.  The sum is deterministic with
// no float atomics.  Blocks are issued in order of key tile and a block
// waits only on the tile before it, which is running or done; a wait
// that never ends traps after about 2 s instead of hanging the card.
// Under causal a key tile's blocks see the most query tiles first.
// - Register patches as in flash_attention_fwd_f32.cu: at head_dim <= 64
//   a block of 128 threads, a thread owning 4 rows by 8 keys of the score
//   tile (8 lanes a row, keys 8 apart and rows 16 apart so a warp's
//   16-byte reads hit distinct banks) and 4 rows by d/8 columns of each
//   output patch: each 16-byte load feeds 10.7 multiply-adds.  At
//   head_dim 128, 256 threads with 16 lanes a row, so the dK, dV and dQ
//   patches stay in registers.
// - Tiles stream into shared memory by 16-byte cp.async, each into its
//   own buffer and staggered so a load overlaps the product before the
//   one that needs it: the next q tile lands while dV is summed, the next
//   dO tile while the dQ share is.
// - At head_dim <= 64 two blocks fit an SM (shared memory and registers).
// Ragged rows and columns are zero-filled by the copies; rows past t_q
// get lse = +inf (so P = 0); keys past t_kv are masked (a zero key
// scores 0, not -inf) and their dK and dV rows never written.  q, k, v
// and dO are read through their strides (the q, k, v slices of a fused
// projection need no copy); the wrapper copies a view whose rows are not
// 16-byte aligned.
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int TILE = 64;              // queries of a query tile, keys of a key tile
constexpr int ROWS = 4;               // rows of a thread's patch
constexpr int RSTEP = TILE / ROWS;    // a score patch's rows: r + RSTEP i
constexpr int DELTA_THREADS = 256;
constexpr int MAX_TILES = 65535;      // gridDim.y limit

template <int D>
struct Cfg {
  static constexpr int LANES = D <= 64 ? 8 : 16;    // threads sharing a row
  static constexpr int THREADS = TILE / ROWS * LANES;
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  static constexpr int KEYS = TILE / LANES;         // score columns a thread
  static constexpr int CC = D / (4 * LANES);        // 16-byte columns a thread
  static constexpr int LD = D + 4;                  // padded row of a tile
  static constexpr int LDP = TILE + 4;              // padded row of P and dS
  static constexpr int TILE_FLOATS = TILE * LD;
  static constexpr int SMEM =
      (4 * TILE_FLOATS + 2 * TILE * LDP) * static_cast<int>(sizeof(float));
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;
  float* dq;
  float* dk;
  float* dv;
  float* delta;
  int* turns;      // [b*h, query tiles]: dQ shares added so far
  int b, h, t_q, t_kv, d;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh, do_sb, do_st, do_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// every group of this thread but the newest `N` has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [t0, t0 + 64) of one head's [t, d] slice (row stride st) into
// s[64][LD]; rows past t_lim and columns past d are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long st, int t0, int t_lim,
                                          int d, int tid) {
  using C = Cfg<D>;
  constexpr int VEC = D / 4;   // 16-byte vectors per row
#pragma unroll
  for (int i = tid; i < TILE * VEC; i += C::THREADS) {
    const int row = i / VEC, c = (i % VEC) * 4, t = t0 + row;
    const int n = t < t_lim ? min(4, max(0, d - c)) : 0;
    cp_async16(s + row * C::LD + c, n ? g + t * st + c : g, 4 * n);
  }
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// out[i][j] = row r + RSTEP i of sa . row tx + LANES j of sb, over D
// columns: the rows of a warp's lanes are 1 apart, so their 16-byte
// reads of sa hit distinct banks
template <int D>
__device__ __forceinline__ void row_dots(const float* sa, const float* sb,
                                         int r, int tx,
                                         float (&out)[ROWS][Cfg<D>::KEYS]) {
  using C = Cfg<D>;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < C::KEYS; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 bc[C::KEYS];
#pragma unroll
    for (int j = 0; j < C::KEYS; ++j)
      bc[j] = *reinterpret_cast<const float4*>(sb + (tx + C::LANES * j) * C::LD
                                               + c);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float4 ac =
          *reinterpret_cast<const float4*>(sa + (r + RSTEP * i) * C::LD + c);
#pragma unroll
      for (int j = 0; j < C::KEYS; ++j) out[i][j] = dot4(ac, bc[j], out[i][j]);
    }
  }
}

// acc[i][cc] += sum over the 64 rows m of w[m][r0 + i] * x[m][columns
// tx*4 + 4 LANES cc + (0..3)]: w a [64][LDP] tile read by columns, x a
// [64][LD] tile
template <int D>
__device__ __forceinline__ void accumulate_t(const float* w, const float* x,
                                             int r0, int tx,
                                             float (&acc)[ROWS][Cfg<D>::CC][4]) {
  using C = Cfg<D>;
#pragma unroll 2
  for (int m = 0; m < TILE; ++m) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + m * C::LDP + r0);
#pragma unroll
    for (int cc = 0; cc < C::CC; ++cc) {
      const float4 xv = *reinterpret_cast<const float4*>(
          x + m * C::LD + tx * 4 + 4 * C::LANES * cc);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float wi = lane(w4, i);
        acc[i][cc][0] = fmaf(wi, xv.x, acc[i][cc][0]);
        acc[i][cc][1] = fmaf(wi, xv.y, acc[i][cc][1]);
        acc[i][cc][2] = fmaf(wi, xv.z, acc[i][cc][2]);
        acc[i][cc][3] = fmaf(wi, xv.w, acc[i][cc][3]);
      }
    }
  }
}

// rows t0 + r + step i (< t_lim) of a contiguous [b, t_lim, h, d]
// output, times mul, from a thread's patch
template <int D>
__device__ __forceinline__ void store_patch(float* out,
                                            const float (&acc)[ROWS][Cfg<D>::CC][4],
                                            int bi, int hi, int t0, int r,
                                            int step, int tx, int t_lim,
                                            int h, int d, float mul) {
  using C = Cfg<D>;
  const bool vec = (d & 3) == 0;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = t0 + r + step * i;
    if (t >= t_lim) continue;
    float* row = out + (static_cast<long long>(bi) * t_lim + t) * h * d +
                 static_cast<long long>(hi) * d;
#pragma unroll
    for (int cc = 0; cc < C::CC; ++cc) {
      const int col = tx * 4 + 4 * C::LANES * cc;
      const float4 v4 = make_float4(acc[i][cc][0] * mul, acc[i][cc][1] * mul,
                                    acc[i][cc][2] * mul, acc[i][cc][3] * mul);
      if (vec && col + 3 < d) {
        *reinterpret_cast<float4*>(row + col) = v4;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) row[col + e] = lane(v4, e);
      }
    }
  }
}

// lse * log2(e) (+inf where the row sees no key or lies past t_q, so
// exp2 gives P = 0) and delta of rows q0 + r + RSTEP i
__device__ __forceinline__ void row_stats(const Args& a, int bh, int q0,
                                          int r, float (&l2)[ROWS],
                                          float (&dl)[ROWS]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + r + RSTEP * i;
    const long long at = static_cast<long long>(bh) * a.t_q + qi;
    const float lse = qi < a.t_q ? a.lse[at] : -INFINITY;
    l2[i] = lse == -INFINITY ? INFINITY : lse * LOG2E;
    dl[i] = qi < a.t_q ? a.delta[at] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[ROWS][Cfg<D>::CC][4]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int cc = 0; cc < Cfg<D>::CC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][cc][e] = 0.f;
}

// adds a thread's dQ share, rows t0 + r + RSTEP i (< t_lim), into the
// contiguous [b, t_lim, h, d] dq: the first turn stores it, the others add
// it to what the earlier turns left (read from L2, where they wrote it),
// and the last stores the sum times mul
template <int D>
__device__ __forceinline__ void add_share(float* out,
                                          const float (&acc)[ROWS][Cfg<D>::CC][4],
                                          int bi, int hi, int t0, int r,
                                          int tx, int t_lim, int h, int d,
                                          bool first, bool last, float mul) {
  using C = Cfg<D>;
  const bool vec = (d & 3) == 0;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = t0 + r + RSTEP * i;
    if (t >= t_lim) continue;
    float* row = out + (static_cast<long long>(bi) * t_lim + t) * h * d +
                 static_cast<long long>(hi) * d;
#pragma unroll
    for (int cc = 0; cc < C::CC; ++cc) {
      const int col = tx * 4 + 4 * C::LANES * cc;
      float4 v4 = make_float4(acc[i][cc][0], acc[i][cc][1], acc[i][cc][2],
                              acc[i][cc][3]);
      if (vec && col + 3 < d) {
        float4* at = reinterpret_cast<float4*>(row + col);
        if (!first) {
          const float4 old = __ldcg(at);
          v4 = make_float4(old.x + v4.x, old.y + v4.y, old.z + v4.z,
                           old.w + v4.w);
        }
        if (last)
          *at = make_float4(v4.x * mul, v4.y * mul, v4.z * mul, v4.w * mul);
        else
          __stcg(at, v4);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + e >= d) continue;
          float x = lane(v4, e);
          if (!first) x += __ldcg(row + col + e);
          if (last)
            row[col + e] = x * mul;
          else
            __stcg(row + col + e, x);
        }
      }
    }
  }
}

// delta[bh, t] = sum_c dO[t, c] * O[t, c], one warp a row
__global__ void __launch_bounds__(DELTA_THREADS) flash_bwd_delta_f32(
    const Args a) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (DELTA_THREADS / 32) +
      threadIdx.x / 32;
  if (row >= static_cast<long long>(a.b) * a.h * a.t_q) return;
  const int t = static_cast<int>(row % a.t_q);
  const int bh = static_cast<int>(row / a.t_q);
  const int bi = bh / a.h, hi = bh % a.h;
  const float* o = a.o + bi * a.o_sb + hi * a.o_sh + t * a.o_st;
  const float* g = a.dout + bi * a.do_sb + hi * a.do_sh + t * a.do_st;
  float acc = 0.f;
  for (int c = threadIdx.x % 32; c < a.d; c += 32)
    acc = fmaf(g[c], o[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) a.delta[row] = acc;
}

// dK and dV of one (batch*head, 64-key tile) over the query tiles it
// sees, and this key tile's share of their dQ
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
    flash_bwd_f32(const Args a) {
  using C = Cfg<D>;
  constexpr int LDP = C::LDP, LANES = C::LANES, KEYS = C::KEYS;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);   // [64][LD]
  float* sv = sk + C::TILE_FLOATS;                // [64][LD]
  float* sq = sv + C::TILE_FLOATS;                // [64][LD], this q tile
  float* sdo = sq + C::TILE_FLOATS;               // [64][LD], this dO tile
  float* sp = sdo + C::TILE_FLOATS;               // [64][LDP], P [query][key]
  float* sds = sp + TILE * LDP;                   // [64][LDP], dS

  const int bh = blockIdx.x, bi = bh / a.h, hi = bh % a.h;
  const int kt = blockIdx.y, k0 = kt * TILE;
  const int tid = threadIdx.x, tx = tid % LANES;
  const int g = tid / LANES, r0 = g * ROWS;
  const int t_q = a.t_q, t_kv = a.t_kv, d = a.d;
  const float sl2 = a.scale * LOG2E;
  const float* q = a.q + bi * a.q_sb + hi * a.q_sh;
  const float* dout = a.dout + bi * a.do_sb + hi * a.do_sh;
  const int n_qb = (t_q + TILE - 1) / TILE;
  const int n_kt = (t_kv + TILE - 1) / TILE;
  // under causal, query tiles wholly above this key tile see none of it
  const int qb0 = a.causal ? k0 / TILE : 0;

  // copy groups, oldest first: {K, V, q_qb0}, {dO_qb0}, then per tile
  // {q_qb+1}, {dO_qb+1}
  load_tile<D>(sk, a.k + bi * a.k_sb + hi * a.k_sh, a.k_st, k0, t_kv, d, tid);
  load_tile<D>(sv, a.v + bi * a.v_sb + hi * a.v_sh, a.v_st, k0, t_kv, d, tid);
  if (qb0 < n_qb) load_tile<D>(sq, q, a.q_st, qb0 * TILE, t_q, d, tid);
  cp_async_commit();
  if (qb0 < n_qb) load_tile<D>(sdo, dout, a.do_st, qb0 * TILE, t_q, d, tid);
  cp_async_commit();

  // this thread's dK/dV patch: keys k0 + r0 + i, columns tx*4 + 4 LANES cc
  float dk[ROWS][C::CC][4], dv[ROWS][C::CC][4];
  zero<D>(dk);
  zero<D>(dv);

  for (int qb = qb0; qb < n_qb; ++qb) {
    const int q0 = qb * TILE;
    float l2[ROWS], dl[ROWS];
    row_stats(a, bh, q0, g, l2, dl);

    // S = q K^T and dP = dO V^T over this thread's patch: query rows
    // q0 + g + RSTEP i, keys k0 + tx + LANES j
    cp_async_wait<1>();   // K, V and this q tile
    __syncthreads();
    float s[ROWS][KEYS], dp[ROWS][KEYS];
    row_dots<D>(sq, sk, g, tx, s);
    cp_async_wait<0>();   // this dO tile
    __syncthreads();
    row_dots<D>(sdo, sv, g, tx, dp);
    const bool edge =
        k0 + TILE > t_kv || (a.causal && q0 < k0 + TILE - 1);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const int col = tx + LANES * j;
        float pv = exp2f(fmaf(s[i][j], sl2, -l2[i]));
        const int row = g + RSTEP * i;
        if (edge && (k0 + col >= t_kv || (a.causal && q0 + row < k0 + col)))
          pv = 0.f;
        sp[row * LDP + col] = pv;
        sds[row * LDP + col] = pv * (dp[i][j] - dl[i]);
      }
    __syncthreads();

    // dK += dS^T q, then the next q tile lands while dV += P^T dO runs
    accumulate_t<D>(sds, sq, r0, tx, dk);
    __syncthreads();   // every reader of this q tile is done
    if (qb + 1 < n_qb) load_tile<D>(sq, q, a.q_st, q0 + TILE, t_q, d, tid);
    cp_async_commit();
    accumulate_t<D>(sp, sdo, r0, tx, dv);
    __syncthreads();   // every reader of this dO tile is done
    if (qb + 1 < n_qb) load_tile<D>(sdo, dout, a.do_st, q0 + TILE, t_q, d, tid);
    cp_async_commit();

    // this key tile's share of dQ, dS K: rows q0 + g + RSTEP i, columns
    // tx*4 + 4 LANES cc, four keys a step
    float dq[ROWS][C::CC][4];
    zero<D>(dq);
#pragma unroll 2
    for (int n = 0; n < TILE; n += 4) {
      float4 pr[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pr[i] = *reinterpret_cast<const float4*>(sds + (g + RSTEP * i) * LDP
                                                 + n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 kc[C::CC];
#pragma unroll
        for (int cc = 0; cc < C::CC; ++cc)
          kc[cc] = *reinterpret_cast<const float4*>(
              sk + (n + e) * C::LD + tx * 4 + 4 * LANES * cc);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float w = lane(pr[i], e);
#pragma unroll
          for (int cc = 0; cc < C::CC; ++cc) {
            dq[i][cc][0] = fmaf(w, kc[cc].x, dq[i][cc][0]);
            dq[i][cc][1] = fmaf(w, kc[cc].y, dq[i][cc][1]);
            dq[i][cc][2] = fmaf(w, kc[cc].z, dq[i][cc][2]);
            dq[i][cc][3] = fmaf(w, kc[cc].w, dq[i][cc][3]);
          }
        }
      }
    }
    // add it after the shares of key tiles 0 .. kt - 1, the last of this
    // query tile's key tiles writing dQ
    int* turns = a.turns + static_cast<long long>(bh) * n_qb + qb;
    if (tid == 0) wait_turn(turns, kt);
    __syncthreads();
    const int last = a.causal ? min(qb, n_kt - 1) : n_kt - 1;
    add_share<D>(a.dq, dq, bi, hi, q0, g, tx, t_q, a.h, d, kt == 0,
                 kt == last, a.scale);
    __syncthreads();   // every share is written, and dS and K are read
    if (tid == 0) count_turn(turns);
  }
  cp_async_wait<0>();   // with no query tile to see, K and V still land

  store_patch<D>(a.dk, dk, bi, hi, k0, r0, 1, tx, t_kv, a.h, d, a.scale);
  store_patch<D>(a.dv, dv, bi, hi, k0, r0, 1, tx, t_kv, a.h, d, 1.f);
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.b) * a.h * a.t_q;
  const int rows_per_block = DELTA_THREADS / 32;
  flash_bwd_delta_f32<<<static_cast<unsigned>((rows + rows_per_block - 1) /
                                              rows_per_block),
                        DELTA_THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_qt = (a.t_q + TILE - 1) / TILE;
  err = cudaMemsetAsync(a.turns, 0,
                        static_cast<size_t>(a.b) * a.h * n_qt * sizeof(int),
                        stream);
  if (err != cudaSuccess) return err;
  // blockIdx.y is the key tile: issued in order, so a block's turn never
  // waits on a block that is not yet running
  flash_bwd_f32<D><<<dim3(a.b * a.h, (a.t_kv + TILE - 1) / TILE), C::THREADS,
                     C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// the scratch the wrapper allocates: delta, float32 [b*h, t_q], then the
// dQ turns, int32 [b*h, query tiles]
long long turns_offset(int b, int h, int t_q) {
  return (static_cast<long long>(b) * h * t_q * 4 + 15) / 16 * 16;
}

// Bytes of the scratch buffer mxtt_flash_attention_bwd_f32 needs.
extern "C" long long mxtt_flash_attention_bwd_f32_workspace(int b, int h,
                                                            int t_q, int d) {
  (void)d;
  return turns_offset(b, h, t_q) +
         static_cast<long long>(b) * h * ((t_q + TILE - 1) / TILE) * 4;
}

// Launches the f32 backward on `stream` and returns cudaGetLastError() as
// an int (0 = launched).  `strides` holds 15 element strides: (batch,
// time, head) of q, k, v, O and dO in that order.  The last dimension of
// each is contiguous; the rows of q, k, v and dO are copied by 16-byte
// vectors, so their base addresses and the strides of their dimensions
// longer than 1 are multiples of 16 bytes (the wrapper copies inputs that
// are not).  dq, dk, dv are contiguous [b, t, h, d] float32 buffers, lse a
// contiguous [b*h, t_q] float32 buffer, workspace a buffer of the size
// above.
extern "C" int mxtt_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* workspace, int b, int h, int t_q, int t_kv, int d,
    const long long* st, float scale, int causal, void* stream) {
  if (b <= 0 || h <= 0 || t_q <= 0 || t_kv <= 0 || d <= 0 || d > 128 ||
      (t_q + TILE - 1) / TILE > MAX_TILES ||
      (t_kv + TILE - 1) / TILE > MAX_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(o),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(dq), static_cast<float*>(dk),
               static_cast<float*>(dv), static_cast<float*>(workspace),
               reinterpret_cast<int*>(static_cast<char*>(workspace) +
                                      turns_offset(b, h, t_q)),
               b, h, t_q, t_kv, d,
               st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
               st[8], st[9], st[10], st[11], st[12], st[13], st[14],
               scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return static_cast<int>(launch<32>(a, s));
  if (d <= 64) return static_cast<int>(launch<64>(a, s));
  return static_cast<int>(launch<128>(a, s));
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return error_string(err);
}
