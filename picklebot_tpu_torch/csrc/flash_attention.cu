// Flash attention for Hopper (sm_90a): the forward O = softmax(scale * Q K^T)
// V for every (sequence, head), with the (N, N) score matrix kept on chip,
// and optionally lse = m + log(l) in f32; and the backward, dQ and dK/dV
// from (Q, K, V, dO, lse, D) with P recomputed from lse.
//
// Replaces the Pallas TPU kernels of
//   picklebot_tpu/ops/pallas/flash_packed.py    _fwd_kernel, _fwd_kernel_nolse
//                                               (body _fwd_compute),
//                                               _dq_kernel, _dkv_kernel
//   picklebot_tpu/ops/pallas/flash_attention.py _fwd_kernel, _dq_kernel,
//                                               _dkv_kernel
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
//
// The backward (FlashAttention-2's algorithm, as the Pallas pair runs it):
// with P = exp(scale * Q K^T - lse), dP = dO V^T, D = rowsum(dO * O) (f32,
// computed by the caller) and dS = P * (dP - D),
//   dq_kernel:  dQ = scale * dS K       one thread per query row
//   dkv_kernel: dV = P^T dO, dK = scale * dS^T Q   one thread per key row
// The two kernels recompute S and dP each (dq_kernel does not write P or
// dS out), so no (N, N) tensor reaches device memory and no output element
// is written by more than one thread: no atomics. The thread keeps its own
// row (q and dO, or k and v) and its f32 accumulators in registers and
// streams the other side's 64-row tiles through shared memory as f32; per
// streamed row it computes s, p, dp and ds as scalars, so no key loop needs
// a register array. Numerics follow the Pallas kernels: f32 scores and
// statistics, P rounded to dO's dtype before the dV product and dS to the
// inputs' dtype before the dQ and dK products, f32 accumulation, the
// scale applied at the end. A ragged N is loop bounds only, which equals
// the Pallas kernels' zero padding (zero K rows add nothing to dQ; padded
// query rows carry dO = 0 and add nothing to dK or dV).
//
// What bounds the backward on an H100: 10*N^2*D FLOPs per (sequence, head)
// for the pair (S and dP in each kernel would be 14; the function needs S,
// dP, dV, dQ and dK once), and q, k, v, dO read, dq, dk, dv written, plus
// lse and D. At MobileViT-s's stage 1 (64 x 8 heads, N=784, D=16, bf16)
// that is 5.0e10 FLOPs (51 us) against 93 MB (28 us): operations. Like the
// forward, these are FMA loops on CUDA cores, far above that bound.

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

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dd;                      // D = rowsum(dO * O), f32
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  long long lse_s, lse_h;               // lse and D share one layout
  int S, H, N, n_t;                     // n_t: 64-row tiles of N
  float scale;
};

// One block per (sequence, head, 64-query tile), one thread per query row:
// dQ_i = scale * sum_j round(P_ij (dP_ij - D_i)) k_j over every key j.
template <typename T, int D>
__global__ void __launch_bounds__(kBQ) dq_kernel(BwdArgs a) {
  __shared__ __align__(16) float k_tile[kBK][D];
  __shared__ __align__(16) float v_tile[kBK][D];

  const int qt = blockIdx.x % a.n_t;
  const int sh = blockIdx.x / a.n_t;
  const int h = sh % a.H, s = sh / a.H;
  const int row = qt * kBQ + threadIdx.x;
  const bool active = row < a.N;

  const T* q = static_cast<const T*>(a.q) + s * a.qs.s + h * a.qs.h;
  const T* k = static_cast<const T*>(a.k) + s * a.ks.s + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + s * a.vs.s + h * a.vs.h;
  const T* dout = static_cast<const T*>(a.dout) + s * a.dos.s + h * a.dos.h;

  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f(q[row * a.qs.n + d]) : 0.f;
    dor[d] = active ? to_f(dout[row * a.dos.n + d]) : 0.f;
    acc[d] = 0.f;
  }
  const long long r = s * a.lse_s + h * a.lse_h + row;
  const float lse = active ? a.lse[r] : 0.f;
  const float dd = active ? a.dd[r] : 0.f;

  for (int k0 = 0; k0 < a.N; k0 += kBK) {
    const int nk = min(kBK, a.N - k0);
    __syncthreads();                    // previous tile done with smem
    for (int idx = threadIdx.x; idx < nk * D; idx += kBQ) {
      const int j = idx / D, d = idx % D;
      k_tile[j][d] = to_f(k[(k0 + j) * a.ks.n + d]);
      v_tile[j][d] = to_f(v[(k0 + j) * a.vs.n + d]);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sc = fmaf(qr[d], k_tile[j][d], sc);
        dp = fmaf(dor[d], v_tile[j][d], dp);
      }
      const float p = expf(sc * a.scale - lse);
      // dS in the inputs' dtype for the dS K product, as Pallas rounds it
      const float ds = to_f(from_f<T>(p * (dp - dd)));
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, k_tile[j][d], acc[d]);
    }
  }

  if (!active) return;
  T* dq = static_cast<T*>(a.dq) + s * a.dqs.s + h * a.dqs.h + row * a.dqs.n;
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = from_f<T>(acc[d] * a.scale);
}

// One block per (sequence, head, 64-key tile), one thread per key row:
// dV_j = sum_i round(P_ij) dO_i and dK_j = scale * sum_i round(dS_ij) q_i
// over every query i, with the query tiles (q, dO, lse, D) in shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(kBK) dkv_kernel(BwdArgs a) {
  __shared__ __align__(16) float q_tile[kBQ][D];
  __shared__ __align__(16) float do_tile[kBQ][D];
  __shared__ float lse_tile[kBQ];
  __shared__ float dd_tile[kBQ];

  const int kt = blockIdx.x % a.n_t;
  const int sh = blockIdx.x / a.n_t;
  const int h = sh % a.H, s = sh / a.H;
  const int col = kt * kBK + threadIdx.x;
  const bool active = col < a.N;

  const T* q = static_cast<const T*>(a.q) + s * a.qs.s + h * a.qs.h;
  const T* k = static_cast<const T*>(a.k) + s * a.ks.s + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + s * a.vs.s + h * a.vs.h;
  const T* dout = static_cast<const T*>(a.dout) + s * a.dos.s + h * a.dos.h;
  const float* lse = a.lse + s * a.lse_s + h * a.lse_h;
  const float* dd = a.dd + s * a.lse_s + h * a.lse_h;

  float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = active ? to_f(k[col * a.ks.n + d]) : 0.f;
    vr[d] = active ? to_f(v[col * a.vs.n + d]) : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }

  for (int q0 = 0; q0 < a.N; q0 += kBQ) {
    const int nq = min(kBQ, a.N - q0);
    __syncthreads();                    // previous tile done with smem
    for (int idx = threadIdx.x; idx < nq * D; idx += kBK) {
      const int i = idx / D, d = idx % D;
      q_tile[i][d] = to_f(q[(q0 + i) * a.qs.n + d]);
      do_tile[i][d] = to_f(dout[(q0 + i) * a.dos.n + d]);
    }
    for (int i = threadIdx.x; i < nq; i += kBK) {
      lse_tile[i] = lse[q0 + i];
      dd_tile[i] = dd[q0 + i];
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int i = 0; i < nq; ++i) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sc = fmaf(q_tile[i][d], kr[d], sc);
        dp = fmaf(do_tile[i][d], vr[d], dp);
      }
      const float p = expf(sc * a.scale - lse_tile[i]);
      const float pr = to_f(from_f<T>(p));      // P in dO's dtype
      const float ds = to_f(from_f<T>(p * (dp - dd_tile[i])));
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(pr, do_tile[i][d], dv[d]);
        dk[d] = fmaf(ds, q_tile[i][d], dk[d]);
      }
    }
  }

  if (!active) return;
  T* dkp = static_cast<T*>(a.dk) + s * a.dks.s + h * a.dks.h + col * a.dks.n;
  T* dvp = static_cast<T*>(a.dv) + s * a.dvs.s + h * a.dvs.h + col * a.dvs.n;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dkp[d] = from_f<T>(dk[d] * a.scale);
    dvp[d] = from_f<T>(dv[d]);
  }
}

template <typename T>
int launch_bwd(const BwdArgs& a, int D, bool dkv, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(a.n_t) * a.H * a.S;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (D) {
    case 16:
      if (dkv) dkv_kernel<T, 16><<<grid, kBK, 0, stream>>>(a);
      else dq_kernel<T, 16><<<grid, kBQ, 0, stream>>>(a);
      break;
    case 32:
      if (dkv) dkv_kernel<T, 32><<<grid, kBK, 0, stream>>>(a);
      else dq_kernel<T, 32><<<grid, kBQ, 0, stream>>>(a);
      break;
    case 64:
      if (dkv) dkv_kernel<T, 64><<<grid, kBK, 0, stream>>>(a);
      else dq_kernel<T, 64><<<grid, kBQ, 0, stream>>>(a);
      break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int bwd(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* dd, void* dq,
        void* dk, void* dv, int dtype, int S, int H, int N, int D,
        float scale, const long long* strides, void* stream) {
  if (S < 1 || H < 1 || N < 1) return int(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = lse; a.dd = dd;
  a.dq = dq; a.dk = dk; a.dv = dv;
  Strides* st[] = {&a.qs, &a.ks, &a.vs, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 7; ++i)
    *st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.lse_s = strides[21];
  a.lse_h = strides[22];
  a.S = S; a.H = H; a.N = N;
  a.n_t = (N + kBQ - 1) / kBQ;
  a.scale = scale;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(a, D, dkv, st_);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(a, D, dkv, st_);
  return int(cudaErrorInvalidValue);
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

// Backward, same conventions. strides: 23 int64 values, (s, h, n) for q, k,
// v, dO, dq, dk and dv, then (s, h) for lse and D, which share one layout
// (stride 1 along n). fa_bwd_dq writes dq (dk and dv are not touched and
// may be null); fa_bwd_dkv writes dk and dv (dq may be null).
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* dd,
                         void* dq, void* dk, void* dv, int dtype, int S,
                         int H, int N, int D, float scale,
                         const long long* strides, void* stream) {
  return bwd(false, q, k, v, dout, lse, dd, dq, dk, dv, dtype, S, H, N, D,
             scale, strides, stream);
}

extern "C" int fa_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* dd,
                          void* dq, void* dk, void* dv, int dtype, int S,
                          int H, int N, int D, float scale,
                          const long long* strides, void* stream) {
  return bwd(true, q, k, v, dout, lse, dd, dq, dk, dv, dtype, S, H, N, D,
             scale, strides, stream);
}
