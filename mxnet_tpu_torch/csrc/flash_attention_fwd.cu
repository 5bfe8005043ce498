// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mxnet_tpu/op/pallas/flash_attention.py:
// _fwd_kernel (launched by _fwd_impl, wrapped by flash_attention), with its
// semantics:
//   O = softmax(scale * Q K^T + mask) V and lse = per-row logsumexp,
//   q [b, t_q, h, d], k and v [b, t_kv, h, d], O in the input dtype,
//   lse [b*h, t_q] in f32;
//   online softmax (running max m, denominator l, f32 accumulator);
//   the scale applied to the f32 scores after Q K^T;
//   in bf16, P rounded to bf16 before P V, accumulated in f32;
//   keys past t_kv masked; the causal mask top-left aligned
//   (q_pos >= k_pos, no offset when t_q != t_kv);
//   a row with l == 0 gives O = 0 and lse = -inf.
//
// What bounds it on this card: at the serving shapes (b=4, t=1024, h=12,
// d=64, causal) the work is about 128 flop per byte of q, k, v and o, so
// arithmetic, not device memory, is the limit: in f32 the CUDA cores', in
// bf16 the tensor cores' (PERF.md holds the bound and the measured time).
//
// What this first design does about it: it keeps the score matrix out of
// device memory and spends the SM's time on fused multiply-adds.  One
// block of 128 threads per (batch*head, 64-row Q tile) holds its Q tile in
// shared memory and loops over 64-row K/V tiles staged there too, as f32.
// Each thread owns an 8x4 patch of the score tile and the matching 8 rows
// of the output (D/16 columns each), so the online-softmax state and its
// correction stay in the thread's registers; a row's max and sum are
// shuffles across its 16 lanes.  Q and K rows are padded by one float and
// P rows by one, so the column reads of the inner loops hit distinct banks
// or broadcast.  Under causal, K/V tiles wholly above the diagonal are not
// visited, and Q tiles are scheduled heaviest first so the long rows of
// the triangle do not trail.  Ragged edges are masked in the kernel, and
// q, k, v are read through their strides, so the slice views of a fused
// QKV projection need no copy.  Both dtypes compute on the CUDA cores in
// f32; tensor cores (wgmma), TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK_M = 64;                          // query rows per block
constexpr int BLOCK_N = 64;                          // keys per K/V tile
constexpr int THREADS = 128;
constexpr int LANES = 16;                            // threads sharing a row
constexpr int ROWS = BLOCK_M / (THREADS / LANES);    // query rows per thread
constexpr int COLS = BLOCK_N / LANES;                // score columns per thread
constexpr int PP = BLOCK_N + 1;                      // padded row of the P tile
constexpr int MAX_Q_TILES = 65535;                   // gridDim.y limit

template <typename T> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float pv_operand(float x) { return x; }
};

template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  // P as the P V product of the TPU kernel sees it: cast to bf16
  static __device__ __forceinline__ float pv_operand(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int b, h, t_q, t_kv, d;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal;
};

// reductions over the 16 lanes of one row group (a half warp)
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

template <int D>
constexpr int smem_bytes() {
  return (BLOCK_M * (D + 1) + BLOCK_N * (D + 1) + BLOCK_N * D + BLOCK_M * PP) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Args a) {
  constexpr int DP = D + 1;        // padded row of the Q and K tiles
  constexpr int DC = D / LANES;    // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                // [BLOCK_M][DP]
  float* sk = sq + BLOCK_M * DP;   // [BLOCK_N][DP]
  float* sv = sk + BLOCK_N * DP;   // [BLOCK_N][D]
  float* sp = sv + BLOCK_N * D;    // [BLOCK_M][PP]

  const int bh = blockIdx.x;
  const int bi = bh / a.h, hi = bh % a.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;   // heaviest first
  const int tid = threadIdx.x;
  const int tx = tid % LANES;
  const int r0 = (tid / LANES) * ROWS;   // this thread's first tile row
  const int d = a.d, t_q = a.t_q, t_kv = a.t_kv;

  const T* q = static_cast<const T*>(a.q) + bi * a.q_sb + hi * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + bi * a.k_sb + hi * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + bi * a.v_sb + hi * a.v_sh;

  for (int i = tid; i < BLOCK_M * D; i += THREADS) {
    const int r = i / D, c = i % D, t = q0 + r;
    sq[r * DP + c] = (t < t_q && c < d) ? Io<T>::load(q + t * a.q_st + c) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kb = (t_kv + BLOCK_N - 1) / BLOCK_N;
  if (a.causal) {
    const int q_last = min(q0 + BLOCK_M, t_q) - 1;
    n_kb = min(n_kb, q_last / BLOCK_N + 1);
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BLOCK_N;
    __syncthreads();   // every reader of the previous tile is done
    for (int i = tid; i < BLOCK_N * D; i += THREADS) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool in = t < t_kv && c < d;
      sk[r * DP + c] = in ? Io<T>::load(k + t * a.k_st + c) : 0.f;
      sv[r * D + c] = in ? Io<T>::load(v + t * a.v_st + c) : 0.f;
    }
    __syncthreads();

    // S = Q K^T over this thread's 8 x 4 patch
    float s[ROWS][COLS] = {};
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kc[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kc[j] = sk[(tx + j * LANES) * DP + c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qc = sq[(r0 + i) * DP + c];
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qc, kc[j], s[i][j]);
      }
    }

    // mask, scale, online softmax; P goes to shared memory for P V
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kj = k0 + tx + j * LANES;
        const bool live = kj < t_kv && (!a.causal || qi >= kj);
        s[i][j] = live ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        sum += p;
        sp[(r0 + i) * PP + tx + j * LANES] = Io<T>::pv_operand(p);
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();   // a row group's P rows are written and read by its own lanes

    // O += P V over this thread's 8 rows x D/16 columns
#pragma unroll 4
    for (int n = 0; n < BLOCK_N; ++n) {
      float vc[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vc[c] = sv[n * D + tx + c * LANES];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = sp[(r0 + i) * PP + n];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vc[c], acc[i][c]);
      }
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= t_q) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (static_cast<long long>(bi * t_q + qi) * a.h + hi) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + c * LANES;
      if (col < d) Io<T>::store(orow + col, acc[i][c] / l_safe);
    }
    if (tx == 0)
      a.lse[static_cast<long long>(bh) * t_q + qi] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.t_q + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// head_dim pads to the next compiled tile width; padded columns are zeros
template <typename T>
cudaError_t dispatch_head_dim(const Args& a, cudaStream_t stream) {
  if (a.d <= 16) return launch<T, 16>(a, stream);
  if (a.d <= 32) return launch<T, 32>(a, stream);
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  dtype: 0 = float32, 1 = bfloat16.  Strides are in
// elements; the last dimension of q, k and v must be contiguous.  o is a
// contiguous [b, t_q, h, d] buffer, lse a contiguous [b*h, t_q] f32 buffer.
extern "C" int mxtt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int b, int h, int t_q, int t_kv, int d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || t_q <= 0 || t_kv < 0 || d <= 0 ||
      (t_q + BLOCK_M - 1) / BLOCK_M > MAX_Q_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse), b, h, t_q, t_kv, d,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
               scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_head_dim<float>(a, s));
    case 1: return static_cast<int>(dispatch_head_dim<__nv_bfloat16>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
