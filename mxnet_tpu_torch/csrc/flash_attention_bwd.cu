// Flash attention backward on the CUDA cores (sm_90a), one templated
// source for float32 and bfloat16.
//
// Replaces mxnet_tpu/op/pallas/flash_attention.py:_bwd_impl, the backward
// half of the JAX package's flash_attention custom_vjp (a blockwise
// recompute over key blocks), with its contract and numerics:
//   inputs q [b, t_q, h, d], k and v [b, t_kv, h, d], the forward's O
//   [b, t_q, h, d] and lse float32 [b*h, t_q], and dO [b, t_q, h, d];
//   outputs dQ, dK, dV in the inputs' dtype, contiguous [b, t, h, d];
//   delta = rowsum(dO * O) in float32;
//   P recomputed as exp(q_s K^T - lse) with q_s = q * scale, keys past
//   t_kv and (under causal) keys above the top-left diagonal masked, and
//   P = 0 on a row whose lse is -inf;
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - delta), dQ = dS K * scale,
//   dK = dS^T q_s.
//   float32 inputs stay float32 throughout.  bfloat16 inputs feed every
//   product in bfloat16 with float32 accumulation: q_s is formed in
//   float32 and rounded to bfloat16, P is rounded before dV and dS before
//   dQ and dK; exp and the dS combination stay float32.  Here a product
//   of two bfloat16 values is formed exactly in float32 and summed in
//   float32, which is what a bfloat16 matrix unit with float32
//   accumulation computes.
//
// What bounds it on this card: five products of 2 b h t_q t_kv d
// operations (halved under causal), float32 on the CUDA cores at 67
// TFLOP/s, or bfloat16 at 989 TFLOP/s on the tensor cores.  At the
// serving shapes that is arithmetic, not device memory (PERF.md holds the
// bound and the time).
//
// What the design does about it, simply: three kernels, deterministic,
// no atomics.  A preprocess takes delta, one warp a row.  The dK/dV
// kernel gives a block of 256 threads one (batch*head, 64-key tile) and
// keeps that tile's K and V in shared memory while it loops over the
// query tiles the mask lets it see; the dQ kernel gives a block one
// (batch*head, 64-row query tile) and loops over key tiles.  Each
// recomputes S and dP, so the card does seven products where the
// function needs five; no block ever writes what another block writes.
// Every product runs from shared memory as float32 fused multiply-adds
// in 4 x 4 (S, dP) or 4 x d/16 (dK, dV, dQ) register patches fed by
// 16-byte loads, each thread's keys 16 apart so a warp's loads hit
// distinct banks.  q, k, v, O and dO are read through their strides
// (the q, k, v views of a fused projection need no copy), one element
// at a time, since the products, not the loads, set the time.  Tensor
// cores (wgmma, fed by TMA) for bfloat16 are a later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // query rows per tile
constexpr int BN = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int TX = 16;          // lanes across a tile's keys or columns
constexpr int R = 4;            // rows (or keys) of a thread's patch
constexpr int NJ = BN / TX;     // keys of a thread's S patch
constexpr int LDP = BN + 4;     // padded row of the P and dS tiles
constexpr int LDT = BM + 4;     // padded row of the transposed dS tile
constexpr int MAX_TILES = 65535;          // gridDim.y limit
constexpr float LOG2E = 1.44269504088896341f;

template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;
  T* dq;
  T* dk;
  T* dv;
  float* delta;
  int b, h, t_q, t_kv, d;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh, do_sb, do_st, do_sh;
  float scale;
  int causal;
};

template <int D>
struct Cfg {
  static constexpr int LD = D + 4;   // padded row of a q, dO, K or V tile
  static constexpr int CC = D / TX;  // columns of a thread's d-wide patch
  static constexpr int TILE = 64 * LD;
  static constexpr int SMEM_KV =
      (4 * TILE + 2 * BM * LDP + 2 * BM) * static_cast<int>(sizeof(float));
  static constexpr int SMEM_Q =
      (4 * TILE + BN * LDT) * static_cast<int>(sizeof(float));
};

// rows [t0, t0 + 64) of one head's [t, d] slice (row stride st), times
// mul and rounded to T, into s[64][LD] as float; rows past t_lim and
// columns past d are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* s, const T* g, long long st,
                                          int t0, int t_lim, int d,
                                          float mul) {
  constexpr int LD = Cfg<D>::LD;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D, t = t0 + r;
    float x = 0.f;
    if (t < t_lim && c < d) x = Num<T>::round(Num<T>::load(g + t * st + c) * mul);
    s[r * LD + c] = x;
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

// S = q_s K^T and dP = dO V^T over this thread's patch: query rows
// ry*4 + i of the q_s/dO tiles, keys tx + 16 j of the K/V tiles
template <int D>
__device__ __forceinline__ void scores(const float* sq, const float* sdo,
                                       const float* sk, const float* sv,
                                       int ry, int tx, float (&s)[R][NJ],
                                       float (&dp)[R][NJ]) {
  constexpr int LD = Cfg<D>::LD;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 kc[NJ], vc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kc[j] = *reinterpret_cast<const float4*>(sk + (tx + TX * j) * LD + c);
      vc[j] = *reinterpret_cast<const float4*>(sv + (tx + TX * j) * LD + c);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 qc =
          *reinterpret_cast<const float4*>(sq + (ry * R + i) * LD + c);
      const float4 oc =
          *reinterpret_cast<const float4*>(sdo + (ry * R + i) * LD + c);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = dot4(qc, kc[j], s[i][j]);
        dp[i][j] = dot4(oc, vc[j], dp[i][j]);
      }
    }
  }
}

// P and dS from S and dP in place, for query rows q0 + ry*4 + i and keys
// k0 + tx + 16 j: s becomes P (float32), dp becomes dS (float32)
__device__ __forceinline__ void softmax_grad(float (&s)[R][NJ],
                                             float (&dp)[R][NJ],
                                             const float (&lse)[R],
                                             const float (&delta)[R], int q0,
                                             int k0, int ry, int tx, int t_q,
                                             int t_kv, int causal) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ry * R + i;
    const float l2 = lse[i] * LOG2E;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kj = k0 + tx + TX * j;
      const bool live = qi < t_q && kj < t_kv && !(causal && qi < kj) &&
                        lse[i] != -INFINITY;
      const float p = live ? exp2f(fmaf(s[i][j], LOG2E, -l2)) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta[i]);
    }
  }
}

// delta[bh, t] = sum_c dO[t, c] * O[t, c] in float32, one warp a row
template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_delta(Args<T> a) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (row >= static_cast<long long>(a.b) * a.h * a.t_q) return;
  const int t = static_cast<int>(row % a.t_q);
  const int bh = static_cast<int>(row / a.t_q);
  const int bi = bh / a.h, hi = bh % a.h;
  const T* o = a.o + bi * a.o_sb + hi * a.o_sh + t * a.o_st;
  const T* g = a.dout + bi * a.do_sb + hi * a.do_sh + t * a.do_st;
  float acc = 0.f;
  for (int c = threadIdx.x % 32; c < a.d; c += 32)
    acc = fmaf(Num<T>::load(g + c), Num<T>::load(o + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) a.delta[row] = acc;
}

// dK and dV of one (batch*head, key tile), over the query tiles it sees
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bwd_dkdv(Args<T> a) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, CC = C::CC;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);   // [BN][LD]
  float* sv = sk + C::TILE;                       // [BN][LD]
  float* sq = sv + C::TILE;                       // [BM][LD], q * scale
  float* sdo = sq + C::TILE;                      // [BM][LD]
  float* sp = sdo + C::TILE;                      // [BM][LDP], P
  float* sds = sp + BM * LDP;                     // [BM][LDP], dS
  float* slse = sds + BM * LDP;                   // [BM]
  float* sdelta = slse + BM;                      // [BM]

  const int bh = blockIdx.x, bi = bh / a.h, hi = bh % a.h;
  const int k0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid % TX, ry = tid / TX;
  const int t_q = a.t_q, t_kv = a.t_kv, d = a.d;
  const T* q = a.q + bi * a.q_sb + hi * a.q_sh;
  const T* dout = a.dout + bi * a.do_sb + hi * a.do_sh;

  load_tile<T, D>(sk, a.k + bi * a.k_sb + hi * a.k_sh, a.k_st, k0, t_kv, d,
                  1.f);
  load_tile<T, D>(sv, a.v + bi * a.v_sb + hi * a.v_sh, a.v_st, k0, t_kv, d,
                  1.f);

  // this thread's dK/dV patch: keys ry*4 + i, columns tx + 16 cc
  float dk[R][CC], dv[R][CC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) dk[i][cc] = dv[i][cc] = 0.f;

  // under causal, query tiles wholly above this key tile see none of it
  const int qb0 = a.causal ? k0 / BM : 0;
  const int n_qb = (t_q + BM - 1) / BM;
  for (int qb = qb0; qb < n_qb; ++qb) {
    const int q0 = qb * BM;
    __syncthreads();   // the last tile's readers are done
    load_tile<T, D>(sq, q, a.q_st, q0, t_q, d, a.scale);
    load_tile<T, D>(sdo, dout, a.do_st, q0, t_q, d, 1.f);
    if (tid < BM) {
      const int qi = q0 + tid;
      slse[tid] = qi < t_q ? a.lse[static_cast<long long>(bh) * t_q + qi]
                           : -INFINITY;
      sdelta[tid] =
          qi < t_q ? a.delta[static_cast<long long>(bh) * t_q + qi] : 0.f;
    }
    __syncthreads();

    float s[R][NJ], dp[R][NJ], lse[R], delta[R];
    scores<D>(sq, sdo, sk, sv, ry, tx, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      lse[i] = slse[ry * R + i];
      delta[i] = sdelta[ry * R + i];
    }
    softmax_grad(s, dp, lse, delta, q0, k0, ry, tx, t_q, t_kv, a.causal);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        sp[(ry * R + i) * LDP + tx + TX * j] = Num<T>::round(s[i][j]);
        sds[(ry * R + i) * LDP + tx + TX * j] = Num<T>::round(dp[i][j]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T q_s over this tile's query rows
#pragma unroll 2
    for (int m = 0; m < BM; ++m) {
      const float4 p4 = *reinterpret_cast<const float4*>(sp + m * LDP + ry * R);
      const float4 s4 =
          *reinterpret_cast<const float4*>(sds + m * LDP + ry * R);
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float og = sdo[m * LD + tx + TX * cc];
        const float qg = sq[m * LD + tx + TX * cc];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv[i][cc] = fmaf(lane(p4, i), og, dv[i][cc]);
          dk[i][cc] = fmaf(lane(s4, i), qg, dk[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ry * R + i;
    if (kj >= t_kv) continue;
    const long long base = (static_cast<long long>(bi * t_kv + kj) * a.h + hi) * d;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const int col = tx + TX * cc;
      if (col < d) {
        Num<T>::store(a.dk + base + col, dk[i][cc]);
        Num<T>::store(a.dv + base + col, dv[i][cc]);
      }
    }
  }
}

// dQ of one (batch*head, query tile), over the key tiles it sees
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bwd_dq(Args<T> a) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, CC = C::CC;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // [BM][LD], q * scale
  float* sdo = sq + C::TILE;                      // [BM][LD]
  float* sk = sdo + C::TILE;                      // [BN][LD]
  float* sv = sk + C::TILE;                       // [BN][LD]
  float* sdst = sv + C::TILE;                     // [BN][LDT], dS^T

  const int bh = blockIdx.x, bi = bh / a.h, hi = bh % a.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest first
  const int tid = threadIdx.x, tx = tid % TX, ry = tid / TX;
  const int t_q = a.t_q, t_kv = a.t_kv, d = a.d;
  const T* k = a.k + bi * a.k_sb + hi * a.k_sh;
  const T* v = a.v + bi * a.v_sb + hi * a.v_sh;

  load_tile<T, D>(sq, a.q + bi * a.q_sb + hi * a.q_sh, a.q_st, q0, t_q, d,
                  a.scale);
  load_tile<T, D>(sdo, a.dout + bi * a.do_sb + hi * a.do_sh, a.do_st, q0,
                  t_q, d, 1.f);
  float lse[R], delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ry * R + i;
    const long long at = static_cast<long long>(bh) * t_q + qi;
    lse[i] = qi < t_q ? a.lse[at] : -INFINITY;
    delta[i] = qi < t_q ? a.delta[at] : 0.f;
  }

  // this thread's dQ patch: query rows ry*4 + i, columns tx + 16 cc
  float dq[R][CC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) dq[i][cc] = 0.f;

  int n_kb = (t_kv + BN - 1) / BN;
  if (a.causal) n_kb = min(n_kb, (min(q0 + BM, t_q) - 1) / BN + 1);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();   // the last tile's readers are done
    load_tile<T, D>(sk, k, a.k_st, k0, t_kv, d, 1.f);
    load_tile<T, D>(sv, v, a.v_st, k0, t_kv, d, 1.f);
    __syncthreads();

    float s[R][NJ], dp[R][NJ];
    scores<D>(sq, sdo, sk, sv, ry, tx, s, dp);
    softmax_grad(s, dp, lse, delta, q0, k0, ry, tx, t_q, t_kv, a.causal);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float4*>(sdst + (tx + TX * j) * LDT + ry * R) =
          make_float4(Num<T>::round(dp[0][j]), Num<T>::round(dp[1][j]),
                      Num<T>::round(dp[2][j]), Num<T>::round(dp[3][j]));
    __syncthreads();

    // dQ += dS K over this tile's keys
#pragma unroll 2
    for (int n = 0; n < BN; ++n) {
      const float4 d4 =
          *reinterpret_cast<const float4*>(sdst + n * LDT + ry * R);
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float kg = sk[n * LD + tx + TX * cc];
#pragma unroll
        for (int i = 0; i < R; ++i) dq[i][cc] = fmaf(lane(d4, i), kg, dq[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ry * R + i;
    if (qi >= t_q) continue;
    const long long base = (static_cast<long long>(bi * t_q + qi) * a.h + hi) * d;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const int col = tx + TX * cc;
      if (col < d) Num<T>::store(a.dq + base + col, dq[i][cc] * a.scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_KV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_Q);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.b) * a.h * a.t_q;
  bwd_delta<T><<<static_cast<unsigned>((rows + THREADS / 32 - 1) /
                                       (THREADS / 32)),
                 THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv<T, D><<<dim3(a.b * a.h, (a.t_kv + BN - 1) / BN), THREADS,
                   C::SMEM_KV, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq<T, D><<<dim3(a.b * a.h, (a.t_q + BM - 1) / BM), THREADS, C::SMEM_Q,
                 stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* dq, void* dk, void* dv,
        void* delta, int b, int h, int t_q, int t_kv, int d,
        const long long* st, float scale, int causal, void* stream) {
  if (b <= 0 || h <= 0 || t_q <= 0 || t_kv <= 0 || d <= 0 || d > 128 ||
      (t_q + BM - 1) / BM > MAX_TILES || (t_kv + BN - 1) / BN > MAX_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(o),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<T*>(dq), static_cast<T*>(dk),
                  static_cast<T*>(dv), static_cast<float*>(delta),
                  b, h, t_q, t_kv, d,
                  st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                  st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                  scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return static_cast<int>(launch<T, 32>(a, s));
  if (d <= 64) return static_cast<int>(launch<T, 64>(a, s));
  return static_cast<int>(launch<T, 128>(a, s));
}

}  // namespace

// Launch the backward on `stream` and return cudaGetLastError() as an int
// (0 = launched).  `strides` holds 15 element strides: (batch, time, head)
// of q, k, v, O and dO in that order; the last dimension of each is
// contiguous (the wrapper copies one that is not).  dq, dk, dv are
// contiguous [b, t, h, d] buffers of the inputs' dtype, lse a contiguous
// [b*h, t_q] float32 buffer, delta a [b*h, t_q] float32 scratch buffer.
extern "C" int mxtt_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int b, int h, int t_q, int t_kv, int d,
    const long long* strides, float scale, int causal, void* stream) {
  return run<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, h, t_q,
                    t_kv, d, strides, scale, causal, stream);
}

extern "C" int mxtt_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int b, int h, int t_q, int t_kv, int d,
    const long long* strides, float scale, int causal, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, h,
                            t_q, t_kv, d, strides, scale, causal, stream);
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
