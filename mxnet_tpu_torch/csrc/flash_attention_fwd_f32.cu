// Flash attention forward in float32 on the CUDA cores (sm_90a).
//
// Replaces the Pallas TPU kernel mxnet_tpu/op/pallas/flash_attention.py:
// _fwd_kernel (launched by _fwd_impl, wrapped by flash_attention) for
// float32 inputs, with its semantics:
//   O = softmax(scale * Q K^T + mask) V and lse = per-row logsumexp,
//   q [b, t_q, h, d], k and v [b, t_kv, h, d], O float32 [b, t_q, h, d],
//   lse float32 [b*h, t_q];
//   online softmax (running max m, denominator l, f32 accumulator); the
//   scale applied to the f32 scores; keys past t_kv masked; the causal
//   mask top-left aligned (q_pos >= k_pos); a row with l == 0 gives O = 0
//   and lse = -inf.
//
// What bounds it on this card: the serving tier holds its logits to 1e-4
// of the CPU, so the products are true float32 (TF32 would break that) and
// run on the CUDA cores at 67 TFLOP/s.  At the serving shapes (b=4,
// t=1024, h=12, d=64, causal) that arithmetic, not device memory, is the
// bound (PERF.md holds the bound and the measured time).  To come near it
// the SMs must issue little besides fused multiply-adds, and the loads
// that feed them must come from shared memory at no more than its rate.
//
// What the design does about it.  One block of 128 threads per
// (batch*head, 64-row Q tile), heaviest causal tiles first.  A thread owns
// a patch of 4 query rows by 8 keys of the score tile, and the same rows
// by d/8 columns of O, so the online-softmax state and its correction stay
// in its registers; a row is shared by 8 lanes, whose max and sum are 3
// shuffles.  Each inner-loop step reads 16-byte vectors: Q rows (the same
// address across a row's lanes: a broadcast) and K rows, each thread's
// keys 8 apart so the lanes of a row hit distinct banks, then P rows and V
// columns: 128 multiply-adds for 12 vector loads.  Patches of 8 rows by 8
// keys would read fewer bytes per multiply-add, but at 254 registers a
// thread they leave the SM half the warps and ran about 15% slower
// (PERF.md).  K and V tiles stream into shared memory by 16-byte cp.async,
// each into its own buffer and staggered by half a tile: the next K tile
// loads while the softmax and P V of this one run, the next V tile while
// the next Q K^T runs.  Ragged rows and columns are zero-filled by the copies and
// masked in the kernel; q, k, v are read through their strides, so the
// slices of a fused QKV projection need no copy.  Under causal, K/V tiles
// wholly above the diagonal are not visited.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;                 // query rows per block
constexpr int BLOCK_N = 64;                 // keys per K/V tile
constexpr int LANES = 8;                    // threads sharing a row
constexpr int KEYS = BLOCK_N / LANES;       // score columns per thread
constexpr int ROWS = 4;                     // query rows per thread
constexpr int THREADS = BLOCK_M / ROWS * LANES;
constexpr int PP = BLOCK_N + 4;             // padded row of the P tile
constexpr int MAX_Q_TILES = 65535;          // gridDim.y limit

template <int D>
struct Cfg {
  static constexpr int KP = D + 4;   // padded row of the Q and K tiles
  static constexpr int CC = D / 32;  // float4 groups of O columns per thread
  static constexpr int SMEM =
      (BLOCK_M * KP + BLOCK_N * KP + BLOCK_N * D + BLOCK_M * PP) *
      static_cast<int>(sizeof(float));
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int b, h, t_q, t_kv, d;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale_log2;     // scale * log2(e)
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
// every group of this thread but the newest one has landed
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// rows [t0, t0 + R) of one head's [t, d] slice (row stride st) into
// s[R][P]; rows past t_lim and columns past d are zero-filled
template <int D, int P, int R>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long st, int t0, int t_lim,
                                          int d, int tid) {
  constexpr int VEC = D / 4;   // 16-byte vectors per row
#pragma unroll
  for (int i = tid; i < R * VEC; i += THREADS) {
    const int row = i / VEC, c = (i % VEC) * 4, t = t0 + row;
    const int n = t < t_lim ? min(4, max(0, d - c)) : 0;
    cp_async16(s + row * P + c, n ? g + t * st + c : g, 4 * n);
  }
}

// reductions over the 8 lanes of one row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(Args a) {
  using C = Cfg<D>;
  constexpr int KP = C::KP, CC = C::CC;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // [BLOCK_M][KP]
  float* sk = sq + BLOCK_M * KP;                  // [BLOCK_N][KP]
  float* sv = sk + BLOCK_N * KP;                  // [BLOCK_N][D]
  float* sp = sv + BLOCK_N * D;                   // [BLOCK_M][PP]

  const int bh = blockIdx.x;
  const int bi = bh / a.h, hi = bh % a.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;   // heaviest first
  const int tid = threadIdx.x;
  const int tx = tid % LANES;
  const int r0 = (tid / LANES) * ROWS;   // this thread's first tile row
  const int d = a.d, t_q = a.t_q, t_kv = a.t_kv;
  const float sl2 = a.scale_log2;

  const float* q = a.q + bi * a.q_sb + hi * a.q_sh;
  const float* k = a.k + bi * a.k_sb + hi * a.k_sh;
  const float* v = a.v + bi * a.v_sb + hi * a.v_sh;

  int n_kb = (t_kv + BLOCK_N - 1) / BLOCK_N;
  if (a.causal) {
    const int q_last = min(q0 + BLOCK_M, t_q) - 1;
    n_kb = min(n_kb, q_last / BLOCK_N + 1);
  }

  // copy groups, oldest first: {Q, K_0}, {V_0}, then per tile {K_kb+1},
  // {V_kb+1}; a tile's wait leaves only the newest group in flight
  load_tile<D, KP, BLOCK_M>(sq, q, a.q_st, q0, t_q, d, tid);
  if (n_kb > 0) load_tile<D, KP, BLOCK_N>(sk, k, a.k_st, 0, t_kv, d, tid);
  cp_async_commit();
  if (n_kb > 0) load_tile<D, D, BLOCK_N>(sv, v, a.v_st, 0, t_kv, d, tid);
  cp_async_commit();

  float m[ROWS], l[ROWS], acc[ROWS][CC][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][cc][e] = 0.f;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BLOCK_N;
    cp_async_wait_but_newest();   // Q and K_kb
    __syncthreads();

    // S = Q K^T over this thread's ROWS x 8 patch, four columns a step;
    // its keys are tx + 8 j
    float s[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 kc[KEYS];
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
        kc[j] = *reinterpret_cast<const float4*>(sk + (tx + j * LANES) * KP + c);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qc =
            *reinterpret_cast<const float4*>(sq + (r0 + i) * KP + c);
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
          s[i][j] = fmaf(qc.x, kc[j].x, s[i][j]);
          s[i][j] = fmaf(qc.y, kc[j].y, s[i][j]);
          s[i][j] = fmaf(qc.z, kc[j].z, s[i][j]);
          s[i][j] = fmaf(qc.w, kc[j].w, s[i][j]);
        }
      }
    }
    __syncthreads();   // every reader of K_kb is done
    if (kb + 1 < n_kb)
      load_tile<D, KP, BLOCK_N>(sk, k, a.k_st, k0 + BLOCK_N, t_kv, d,
                                    tid);
    cp_async_commit();

    // scale, mask, online softmax in the log2 domain; P to shared memory
    const bool edge =
        k0 + BLOCK_N > t_kv || (a.causal && k0 + BLOCK_N - 1 > q0);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const int kj = k0 + tx + j * LANES;
        float x = s[i][j] * sl2;
        if (edge && (kj >= t_kv || (a.causal && qi < kj))) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : exp2f(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const float pv = exp2f(s[i][j] - m_safe);
        sum += pv;
        sp[(r0 + i) * PP + tx + j * LANES] = pv;
      }
      // this thread's part of the row sum; the row adds up at the end
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][cc][e] *= corr;
    }
    __syncwarp();     // a row's P is written and read by its own 8 lanes
    cp_async_wait_but_newest();   // V_kb
    __syncthreads();

    // O += P V over this thread's ROWS rows x columns tx*4 + 32 cc + [0, 4)
#pragma unroll 2
    for (int n = 0; n < BLOCK_N; n += 4) {
      float4 pr[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pr[i] = *reinterpret_cast<const float4*>(sp + (r0 + i) * PP + n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vc[CC];
#pragma unroll
        for (int cc = 0; cc < CC; ++cc)
          vc[cc] = *reinterpret_cast<const float4*>(sv + (n + e) * D +
                                                    tx * 4 + 32 * cc);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float pe = lane(pr[i], e);
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) {
            acc[i][cc][0] = fmaf(pe, vc[cc].x, acc[i][cc][0]);
            acc[i][cc][1] = fmaf(pe, vc[cc].y, acc[i][cc][1]);
            acc[i][cc][2] = fmaf(pe, vc[cc].z, acc[i][cc][2]);
            acc[i][cc][3] = fmaf(pe, vc[cc].w, acc[i][cc][3]);
          }
        }
      }
    }
    __syncthreads();   // every reader of V_kb is done
    if (kb + 1 < n_kb)
      load_tile<D, D, BLOCK_N>(sv, v, a.v_st, k0 + BLOCK_N, t_kv, d,
                                   tid);
    cp_async_commit();
  }

  float* o = a.o;
  const bool vec = (d & 3) == 0;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float l_row = row_sum(l[i]);
    const int qi = q0 + r0 + i;
    if (qi >= t_q) continue;
    const float inv = l_row == 0.f ? 0.f : 1.f / l_row;
    float* orow = o + (static_cast<long long>(bi * t_q + qi) * a.h + hi) * d;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const int col = tx * 4 + 32 * cc;
      const float4 out = make_float4(acc[i][cc][0] * inv, acc[i][cc][1] * inv,
                                     acc[i][cc][2] * inv, acc[i][cc][3] * inv);
      if (vec && col + 3 < d) {
        *reinterpret_cast<float4*>(orow + col) = out;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) orow[col + e] = lane(out, e);
      }
    }
    if (tx == 0)
      a.lse[static_cast<long long>(bh) * t_q + qi] =
          m[i] == -INFINITY ? -INFINITY
                            : (m[i] + log2f(l_row)) * 0.69314718055994531f;
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.t_q + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_f32<D><<<grid, THREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches the f32 forward on `stream` and returns cudaGetLastError() as
// an int (0 = launched).  Strides are in elements; the last dimension of
// q, k and v is contiguous, their base addresses and the strides of
// dimensions longer than 1 are multiples of 16 bytes (the wrapper copies
// inputs that are not).  o is a contiguous [b, t_q, h, d] buffer, lse a
// contiguous [b*h, t_q] f32 buffer.
extern "C" int mxtt_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int h, int t_q, int t_kv, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale, int causal,
    void* stream) {
  if (b <= 0 || h <= 0 || t_q <= 0 || t_kv < 0 || d <= 0 || d > 128 ||
      (t_q + BLOCK_M - 1) / BLOCK_M > MAX_Q_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(o),
               static_cast<float*>(lse), b, h, t_q, t_kv, d,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
               scale * 1.44269504088896341f, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return static_cast<int>(launch<32>(a, s));
  if (d <= 64) return static_cast<int>(launch<64>(a, s));
  return static_cast<int>(launch<128>(a, s));
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
