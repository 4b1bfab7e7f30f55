// Stride-1, 'same'-padded dense 3-D convolution for Hopper (sm_90a) on
// channels-last activations: x (B,T,H,W,Ci) * w (Kt,Kh,Kw,Ci,Co) ->
// out (B,T,H,W,Co), f32 accumulation, rounded once to the output dtype.
//
// Replaces the Pallas TPU kernel of picklebot_tpu/ops/pallas/folded_conv.py
// (_kernel, reached through folded_conv_s1): forward, and dx as the same
// kernel on flipped taps with Ci and Co swapped (the wrapper prepares that
// weight). The weight gradient is not a kernel there either.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the function
// reads x and w once and writes out once, and does 2*Kt*Kh*Kw*Ci*Co FLOPs
// per output position. At MobileViT-s's conv1/conv4 (27 taps, Ci 96..320,
// bs 8) that is 900 to 1,700 FLOPs per byte, above the ~295 FLOP/byte
// ridge, so the bound is operations.
//
// Design: an implicit GEMM. The TPU kernel staged whole frames into VMEM
// slabs with the edge masks baked in, merged (h, w) into one row axis and
// packed adjacent W taps to fill 128 lanes; none of that is carried over.
// Here the M axis is the flat output position (b,t,h,w), N is Co and K
// runs over the taps and Ci. One block owns a (kBM positions x kBN output
// channels) tile and loops over every tap and over Ci in chunks of kBK:
//   1. each thread gathers 8 input channels of one position for this tap
//      (zero where the tap leaves the clip in T, H or W: the TPU kernel's
//      clip-edge and row-edge masks) and stores them, as f32 and
//      transposed, into As[k][m];
//   2. the (kBK x kBN) slice of this tap's weights goes into Bs[k][n];
//   3. each thread multiplies its 4x4 register tile: two 16-byte shared
//      loads and 16 FMAs per k.
// Products are plain f32 FMA loops (no tensor cores yet), so this first
// version is bound by the FP32 pipe (67 TFLOP/s), not by the tensor cores'
// 989; mma.sync or wgmma tiles are the next step.
//
// Tails: M, Ci and Co need not be multiples of the tile (Ci, Co = 48, 80,
// 96, 160, 320 ...): rows past M, channels past Ci and columns past Co are
// zero in shared memory and are not written back. Kt, Kh, Kw and the low
// pads are run-time arguments; output dims equal input dims.
//
// Layouts (row-major, contiguous): x (B,T,H,W,Ci); w (Kt*Kh*Kw,Ci,Co);
// out (B,T,H,W,Co); one dtype for all three: float (0) or bf16 (1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;   // output positions per block
constexpr int kBN = 32;    // output channels per block
constexpr int kBK = 16;    // input channels per step
constexpr int kTM = 4;     // register tile: positions per thread
constexpr int kTN = 4;     // register tile: output channels per thread
constexpr int kLoad = 8;   // input channels one thread gathers per step

static_assert(kThreads == kBM * (kBK / kLoad), "one gather per thread");
static_assert(kThreads == (kBM / kTM) * (kBN / kTN), "one tile per thread");

struct Geom {
  int B, T, H, W, Ci, Co;
  int Kt, Kh, Kw;
  int pt, ph, pw;          // low pads
  long long M;             // B*T*H*W
};

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

// 8 consecutive channels from a 16-byte aligned address.
__device__ __forceinline__ void load8_vec(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8_vec(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, Geom g, int vec) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;

  // gather role: position lrow of the tile, channels [lk, lk + kLoad) of
  // each chunk
  const int lrow = tid % kBM;
  const int lk = (tid / kBM) * kLoad;
  const long long lm = m0 + lrow;
  const bool row_in = lm < g.M;
  int lb = 0, lt = 0, lh = 0, lw = 0;
  if (row_in) {
    long long r = lm;
    lw = int(r % g.W); r /= g.W;
    lh = int(r % g.H); r /= g.H;
    lt = int(r % g.T);
    lb = int(r / g.T);
  }

  // multiply role: a kTM x kTN tile of the block's outputs
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  int tap = 0;
  for (int dt = 0; dt < g.Kt; ++dt) {
    for (int dh = 0; dh < g.Kh; ++dh) {
      for (int dw = 0; dw < g.Kw; ++dw, ++tap) {
        const int tt = lt + dt - g.pt;
        const int hh = lh + dh - g.ph;
        const int ww = lw + dw - g.pw;
        const bool valid = row_in && tt >= 0 && tt < g.T && hh >= 0 &&
                           hh < g.H && ww >= 0 && ww < g.W;
        const T* src = x;
        if (valid)
          src = x + (((size_t(lb) * g.T + tt) * g.H + hh) * g.W + ww) *
                        size_t(g.Ci);
        const T* wt = w + size_t(tap) * g.Ci * g.Co;

        for (int c0 = 0; c0 < g.Ci; c0 += kBK) {
          float v[kLoad];
          const int c = c0 + lk;
          if (!valid) {
#pragma unroll
            for (int j = 0; j < kLoad; ++j) v[j] = 0.f;
          } else if (vec && c + kLoad <= g.Ci) {
            load8_vec(src + c, v);
          } else {
#pragma unroll
            for (int j = 0; j < kLoad; ++j)
              v[j] = c + j < g.Ci ? to_f(src[c + j]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kLoad; ++j) As[lk + j][lrow] = v[j];
          for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
            const int k = idx / kBN, n = idx % kBN;
            const int ci = c0 + k, co = co0 + n;
            Bs[k][n] = (ci < g.Ci && co < g.Co)
                           ? to_f(wt[size_t(ci) * g.Co + co]) : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int k = 0; k < kBK; ++k) {
            const float4 a4 =
                *reinterpret_cast<const float4*>(&As[k][ty * kTM]);
            const float4 b4 =
                *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
            const float a[kTM] = {a4.x, a4.y, a4.z, a4.w};
            const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j)
                acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
          __syncthreads();
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int co = co0 + tx * kTN + j;
      if (co < g.Co) out[size_t(m) * g.Co + co] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, const Geom& g,
           cudaStream_t stream) {
  const long long m_tiles = (g.M + kBM - 1) / kBM;
  const int n_tiles = (g.Co + kBN - 1) / kBN;
  if (m_tiles > 2147483647LL || n_tiles > 65535)
    return int(cudaErrorInvalidValue);
  // 16-byte gathers need every position's channel row aligned
  const int vec = (g.Ci % kLoad == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  dim3 grid((unsigned)m_tiles, (unsigned)n_tiles);
  conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), g, vec);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// pt, ph, pw are the low pads; output dims equal input dims. Returns 0, or
// the CUDA error of the launch (cudaErrorInvalidValue for a shape the kernel
// does not take).
extern "C" int fc_conv_s1(const void* x, const void* w, void* out, int dtype,
                          int B, int T, int H, int W, int Ci, int Co, int Kt,
                          int Kh, int Kw, int pt, int ph, int pw,
                          void* stream) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || Kt < 1 ||
      Kh < 1 || Kw < 1 || pt < 0 || ph < 0 || pw < 0 || pt >= Kt ||
      ph >= Kh || pw >= Kw)
    return int(cudaErrorInvalidValue);
  Geom g;
  g.B = B; g.T = T; g.H = H; g.W = W; g.Ci = Ci; g.Co = Co;
  g.Kt = Kt; g.Kh = Kh; g.Kw = Kw; g.pt = pt; g.ph = ph; g.pw = pw;
  g.M = (long long)B * T * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, g, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, g, st);
  return int(cudaErrorInvalidValue);
}
