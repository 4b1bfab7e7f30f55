// Flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V
// for every (sequence, head), with the (N, N) score matrix kept on chip, and
// optionally lse = m + log(l) in f32.
//
// Replaces the forward Pallas TPU kernels of
//   picklebot_tpu/ops/pallas/flash_packed.py    _fwd_kernel, _fwd_kernel_nolse
//                                               (body _fwd_compute)
//   picklebot_tpu/ops/pallas/flash_attention.py _fwd_kernel
// The packed kernel's 128-lane head packing is a TPU layout trick that is
// not carried over: the kernel reads Q, K, V and writes O through the
// sequence, head and token strides it is given, so one kernel serves the
// packed layout (..., N, H*D) with head stride D (and q, k, v read in place
// from the fused qkv projection, token stride 3*H*D) and the per-head
// layout (..., H, N, D).
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the function
// must read Q, K, V and write O once, 4*S*H*N*D elements, and does
// 4*S*H*N^2*D useful FLOPs (QK^T and PV). At MobileViT-s's stage 1
// (S=64 sequences, H=8, N=784, D=16, bf16) that is 51 MB (15.3 us) against
// 2.0e10 FLOPs (20.3 us), so the bound is operations, about 20 us.
//
// Design. A first version that is right and simple: one block of kBQ = 64
// threads per (sequence, head, 64-query tile), one thread per query row.
// The thread keeps its query row, D f32 accumulators and the running max
// and sum in registers. K/V tiles of kBK = 64 rows are staged in shared
// memory as f32; every thread of the block reads the same K/V element at
// once (a broadcast, no bank conflicts). Per tile the thread computes its
// scores in f32 (times scale) into a shared (kBK, kBQ) score tile, takes
// the tile max, rescales, and adds p_j * v_j with p_j rounded to V's dtype
// first, as the Pallas kernel rounds P before its PV product. The output
// is acc / l, cast at the end. A ragged N is handled by loop bounds (the
// last tile's key loops stop at N, rows past N store nothing), with no
// padding copies and no masked scores. Scores live in shared memory, not
// in a register array, so the key loops need not unroll fully: that keeps
// the registers per thread and the build time low (a register array of
// scores forces every key loop to unroll, and nvcc then takes over a
// minute for the six instantiations). Products are FMA loops on
// CUDA cores: no tensor cores (mma.sync, wgmma) and no TMA yet, so the
// kernel sits far above its operations bound.
//
// Layouts: element (s, h, n, d) of q, k, v, o lies at
// s*stride_s + h*stride_h + n*stride_n + d (stride 1 along d); lse (s, h, n)
// at s*lse_s + h*lse_h + n. q, k, v and o share one dtype: float (dtype 0)
// or bf16 (dtype 1). D is 16, 32 or 64.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows (threads) per block
constexpr int kBK = 64;                 // key/value rows per shared tile
constexpr float kNegInf = -1e30f;       // as the Pallas kernels' _NEG_INF

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

struct Strides {
  long long s, h, n;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                           // null: no lse output
  Strides qs, ks, vs, os;
  long long lse_s, lse_h;
  int S, H, N, n_qt;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kBQ) fwd_kernel(Args a) {
  __shared__ __align__(16) float k_tile[kBK][D];
  __shared__ __align__(16) float v_tile[kBK][D];
  __shared__ float s_tile[kBK][kBQ];

  const int qt = blockIdx.x % a.n_qt;
  const int sh = blockIdx.x / a.n_qt;
  const int h = sh % a.H, s = sh / a.H;
  const int row = qt * kBQ + threadIdx.x;
  const bool active = row < a.N;

  const T* q = static_cast<const T*>(a.q) + s * a.qs.s + h * a.qs.h;
  const T* k = static_cast<const T*>(a.k) + s * a.ks.s + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + s * a.vs.s + h * a.vs.h;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f(q[row * a.qs.n + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < a.N; k0 += kBK) {
    const int nk = min(kBK, a.N - k0);
    __syncthreads();                    // previous tile done with smem
    for (int idx = threadIdx.x; idx < nk * D; idx += kBQ) {
      const int r = idx / D, d = idx % D;
      k_tile[r][d] = to_f(k[(k0 + r) * a.ks.n + d]);
      v_tile[r][d] = to_f(v[(k0 + r) * a.vs.n + d]);
    }
    __syncthreads();

    // this thread's scores of the tile, f32, in shared memory (column
    // threadIdx.x: a warp touches 32 consecutive words, no bank conflicts)
    float m_tile = kNegInf;
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], k_tile[j][d], dot);
      dot *= a.scale;
      s_tile[j][threadIdx.x] = dot;
      m_tile = fmaxf(m_tile, dot);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    float l_tile = 0.f;
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float p = expf(s_tile[j][threadIdx.x] - m_new);
      l_tile += p;
      // P in V's dtype for the PV product; the sum l stays f32
      const float pr = to_f(from_f<T>(p));
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pr, v_tile[j][d], acc[d]);
    }
    l = l * alpha + l_tile;
    m = m_new;
  }

  if (!active) return;
  T* o = static_cast<T*>(a.o) + s * a.os.s + h * a.os.h + row * a.os.n;
  const float inv_l = 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = from_f<T>(acc[d] * inv_l);
  if (a.lse != nullptr)
    a.lse[s * a.lse_s + h * a.lse_h + row] = m + logf(l);
}

template <typename T>
int launch(const Args& a, int D, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(a.n_qt) * a.H * a.S;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (D) {
    case 16: fwd_kernel<T, 16><<<grid, kBQ, 0, stream>>>(a); break;
    case 32: fwd_kernel<T, 32><<<grid, kBQ, 0, stream>>>(a); break;
    case 64: fwd_kernel<T, 64><<<grid, kBQ, 0, stream>>>(a); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// strides: 14 int64 values, (s, h, n) for q, k, v and o, then (s, h) for
// lse (ignored when lse is null). Returns 0, or the CUDA error of the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int dtype, int S, int H, int N, int D,
                      float scale, const long long* strides, void* stream) {
  if (S < 1 || H < 1 || N < 1) return int(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lse = static_cast<float*>(lse);
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  a.lse_s = strides[12];
  a.lse_h = strides[13];
  a.S = S; a.H = H; a.N = N;
  a.n_qt = (N + kBQ - 1) / kBQ;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, D, st);
  return int(cudaErrorInvalidValue);
}
