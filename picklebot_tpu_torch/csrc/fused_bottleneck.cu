// Fused inverted-bottleneck kernels for Hopper (sm_90a): expand 1x1 ->
// (1,k,k) depthwise at stride s -> SE channel scale -> project 1x1, with the
// expanded tensor kept on chip.
//
// Replaces the Pallas TPU kernels of picklebot_tpu/ops/pallas/fused_bottleneck.py:
//   _pool_kernel (SE pass 1: per-sample sum of the depthwise output) -> fb_pool
//   _main_kernel (pass 2: expand, depthwise, scale, project)         -> fb_main
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the function
// must read x (B,T,H,W,C) and write the output (B,T',H',W',Co) plus a few
// hundred KB of weights; it does 2*C*E FLOPs per input pixel (expand),
// 2*k*k*E per output pixel (depthwise) and 2*E*Co per output pixel
// (project). At MobileNetLarge3D's widths that is 10-100 FLOPs per byte,
// far under the ~295 FLOP/byte ridge, so the bound is bytes. The unfused
// chain also writes and rereads the expanded tensor (E/C = 1..6x the
// input) twice; keeping it on chip is the whole point of fusing.
//
// Design. The TPU kernel held a whole padded frame and the full expanded
// tile in VMEM. A Hopper block has at most 227 KB of shared memory (one f32
// expanded 5-row tile of block5, E=960, is about 211 KB), so each block owns
// one output tile of (th, tw) pixels and loops over chunks of kEC expanded
// channels:
//   1. the input tile with its halo, (rows_in, cols_in, C), is loaded once;
//   2. per chunk: expand into shared memory (f32 accumulation), apply the
//      depthwise stencil at stride s in f32, and for the main pass scale it,
//      round it to the input dtype and add its share of the projection into
//      f32 register accumulators for the (th*tw, Co) output tile.
// Products are plain FMA loops over shared memory (no tensor cores yet), so
// this first version is bound by shared-memory bandwidth, not by HBM.
//
// The pool pass is deterministic: one block per (sample, E-chunk) walks all
// of that sample's frames and tiles in a fixed order, and the per-thread
// partial sums are reduced in a fixed order. No atomics.
//
// The temporal quirk of Bottleneck3D (temporal kernel 1, but the integer
// stride and the padding k//2 act on T) is index arithmetic: output frame t'
// reads input frame t'*s - k//2, and a frame outside [0, T) is all zero.
// That holds only because the convs carry no bias (the wrapper checks).
//
// Layouts (row-major, contiguous): x (B,T,H,W,C); w1 (C,E); wd (k*k,E);
// w2 (E,Co); scale (B,E) f32; pooled (B,E) f32; out (B,T',H',W',Co).
// x, weights and out share one dtype: float (dtype 0) or bf16 (dtype 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEC = 32;                      // expanded channels per chunk
constexpr int kGroups = kThreads / kEC;      // pixel groups per block
constexpr int kMaxAcc = 40;                  // f32 output accumulators/thread
constexpr int kMaxOutTile = kThreads * kMaxAcc;
constexpr size_t kMaxSmem = 227 * 1024;

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

struct Geom {
  int B, T, H, W, C, E, Co;
  int k, s, p;
  int To, Ho, Wo;
  int th, tw;             // output tile
  int rows_in, cols_in;   // input tile with its halo
  int n_tw, n_tiles;      // tiles along W, tiles per frame
};

// Byte offsets of the shared-memory arrays (16-byte aligned), the same on
// host (for the launch size) and device.
struct Layout {
  size_t xs, w1s, wds, es, w2s, ds, red, total;
};

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~size_t(15);
}

__host__ __device__ inline Layout make_layout(const Geom& g, int elem,
                                              bool main_pass) {
  Layout l;
  size_t q = size_t(g.rows_in) * g.cols_in;
  size_t o = 0;
  l.xs = o;  o = align16(o + q * g.C * elem);
  l.w1s = o; o = align16(o + size_t(g.C) * kEC * 4);
  l.wds = o; o = align16(o + size_t(g.k) * g.k * kEC * 4);
  l.es = o;  o = align16(o + q * kEC * 4);
  if (main_pass) {
    l.w2s = o; o = align16(o + size_t(kEC) * g.Co * 4);
    l.ds = o;  o = align16(o + size_t(g.th) * g.tw * kEC * 4);
    l.red = 0;
  } else {
    l.w2s = l.ds = 0;
    l.red = o; o = align16(o + size_t(kGroups) * kEC * 4);
  }
  l.total = o;
  return l;
}

// Input tile with halo for output tile origin (h0, w0); zero outside the
// frame (the depthwise conv's spatial zero padding, exact because the
// expand has no bias).
template <typename T>
__device__ void load_tile(const T* __restrict__ frame, T* xs, const Geom& g,
                          int h0, int w0) {
  const int hb = h0 * g.s - g.p, wb = w0 * g.s - g.p;
  const int n = g.rows_in * g.cols_in * g.C;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int c = idx % g.C, q = idx / g.C;
    const int hi = hb + q / g.cols_in, wi = wb + q % g.cols_in;
    T v = from_f<T>(0.f);
    if (hi >= 0 && hi < g.H && wi >= 0 && wi < g.W)
      v = frame[(size_t(hi) * g.W + wi) * g.C + c];
    xs[idx] = v;
  }
}

// Chunk [e0, e0+ec) of w1 and wd into shared memory as f32; channels past
// ec are zero, so they expand and convolve to zero.
template <typename T>
__device__ void load_w1_wd(const T* __restrict__ w1, const T* __restrict__ wd,
                           float* w1s, float* wds, const Geom& g, int e0,
                           int ec) {
  for (int idx = threadIdx.x; idx < g.C * kEC; idx += kThreads) {
    const int e = idx % kEC, c = idx / kEC;
    w1s[idx] = e < ec ? to_f(w1[size_t(c) * g.E + e0 + e]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < g.k * g.k * kEC; idx += kThreads) {
    const int e = idx % kEC, t = idx / kEC;
    wds[idx] = e < ec ? to_f(wd[size_t(t) * g.E + e0 + e]) : 0.f;
  }
}

// Expand the input tile into es (rows_in*cols_in, kEC) f32. A thread owns
// channel e = tid % kEC, so a warp reads one broadcast x value and 32
// consecutive weights per step. Pixels outside the frame are zero without
// any arithmetic.
template <typename T>
__device__ void expand(const T* xs, const float* w1s, float* es,
                       const Geom& g, int h0, int w0) {
  const int hb = h0 * g.s - g.p, wb = w0 * g.s - g.p;
  const int nq = g.rows_in * g.cols_in;
  const int e = threadIdx.x % kEC;
  for (int q = threadIdx.x / kEC; q < nq; q += kGroups) {
    const int hi = hb + q / g.cols_in, wi = wb + q % g.cols_in;
    float acc = 0.f;
    if (hi >= 0 && hi < g.H && wi >= 0 && wi < g.W) {
      const T* xq = xs + size_t(q) * g.C;
      for (int c = 0; c < g.C; ++c)
        acc = fmaf(to_f(xq[c]), w1s[c * kEC + e], acc);
    }
    es[q * kEC + e] = acc;
  }
}

// Depthwise (1,k,k) stencil at stride s for tile pixel (i, j), channel e,
// in f32 (same tap order as the Pallas kernel: dy outer, dx inner).
__device__ __forceinline__ float depthwise(const float* es, const float* wds,
                                           const Geom& g, int i, int j,
                                           int e) {
  float acc = 0.f;
  for (int dy = 0; dy < g.k; ++dy) {
    const float* row = es + ((i * g.s + dy) * g.cols_in + j * g.s) * kEC + e;
    const float* wrow = wds + dy * g.k * kEC + e;
    for (int dx = 0; dx < g.k; ++dx)
      acc = fmaf(row[dx * kEC], wrow[dx * kEC], acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const T* __restrict__ x, const T* __restrict__ w1,
            const T* __restrict__ wd, float* __restrict__ pooled, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(g, sizeof(T), false);
  T* xs = reinterpret_cast<T*>(smem + l.xs);
  float* w1s = reinterpret_cast<float*>(smem + l.w1s);
  float* wds = reinterpret_cast<float*>(smem + l.wds);
  float* es = reinterpret_cast<float*>(smem + l.es);
  float* red = reinterpret_cast<float*>(smem + l.red);

  const int b = blockIdx.y, e0 = blockIdx.x * kEC;
  const int ec = min(kEC, g.E - e0);
  const int e = threadIdx.x % kEC, grp = threadIdx.x / kEC;
  load_w1_wd(w1, wd, w1s, wds, g, e0, ec);
  float sum = 0.f;
  for (int to = 0; to < g.To; ++to) {
    const int ti = to * g.s - g.p;
    if (ti < 0 || ti >= g.T) continue;   // zero frame: contributes 0
    const T* frame = x + (size_t(b) * g.T + ti) * g.H * g.W * g.C;
    for (int tile = 0; tile < g.n_tiles; ++tile) {
      const int h0 = (tile / g.n_tw) * g.th, w0 = (tile % g.n_tw) * g.tw;
      __syncthreads();                   // previous tile done with xs/es
      load_tile(frame, xs, g, h0, w0);
      __syncthreads();
      expand(xs, w1s, es, g, h0, w0);
      __syncthreads();
      for (int pix = grp; pix < g.th * g.tw; pix += kGroups) {
        const int i = pix / g.tw, j = pix % g.tw;
        if (h0 + i < g.Ho && w0 + j < g.Wo)
          sum += depthwise(es, wds, g, i, j, e);
      }
    }
  }
  red[grp * kEC + e] = sum;
  __syncthreads();
  if (threadIdx.x < ec) {
    float t = 0.f;
    for (int r = 0; r < kGroups; ++r) t += red[r * kEC + threadIdx.x];
    pooled[size_t(b) * g.E + e0 + threadIdx.x] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
main_kernel(const T* __restrict__ x, const T* __restrict__ w1,
            const T* __restrict__ wd, const T* __restrict__ w2,
            const float* __restrict__ scale, T* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(g, sizeof(T), true);
  T* xs = reinterpret_cast<T*>(smem + l.xs);
  float* w1s = reinterpret_cast<float*>(smem + l.w1s);
  float* wds = reinterpret_cast<float*>(smem + l.wds);
  float* es = reinterpret_cast<float*>(smem + l.es);
  float* w2s = reinterpret_cast<float*>(smem + l.w2s);
  float* ds = reinterpret_cast<float*>(smem + l.ds);

  const int n = blockIdx.y, b = n / g.To, to = n % g.To;
  const int h0 = (blockIdx.x / g.n_tw) * g.th;
  const int w0 = (blockIdx.x % g.n_tw) * g.tw;
  const int npix = g.th * g.tw, total = npix * g.Co;
  T* out_frame = out + size_t(n) * g.Ho * g.Wo * g.Co;
  const int ti = to * g.s - g.p;

  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;

  if (ti >= 0 && ti < g.T) {             // else a zero frame: output 0
    const T* frame = x + (size_t(b) * g.T + ti) * g.H * g.W * g.C;
    load_tile(frame, xs, g, h0, w0);
    const int e = threadIdx.x % kEC, grp = threadIdx.x / kEC;
    for (int e0 = 0; e0 < g.E; e0 += kEC) {
      const int ec = min(kEC, g.E - e0);
      __syncthreads();                   // previous chunk done with smem
      load_w1_wd(w1, wd, w1s, wds, g, e0, ec);
      for (int idx = threadIdx.x; idx < kEC * g.Co; idx += kThreads) {
        const int co = idx % g.Co, ee = idx / g.Co;
        w2s[idx] = ee < ec ? to_f(w2[size_t(e0 + ee) * g.Co + co]) : 0.f;
      }
      __syncthreads();
      expand(xs, w1s, es, g, h0, w0);
      __syncthreads();
      const float sc = e < ec ? scale[size_t(b) * g.E + e0 + e] : 0.f;
      for (int pix = grp; pix < npix; pix += kGroups) {
        const int i = pix / g.tw, j = pix % g.tw;
        // f32 through the stencil and the scale; rounded to the input
        // dtype only as the projection's operand (as in the Pallas kernel)
        const float d = depthwise(es, wds, g, i, j, e) * sc;
        ds[pix * kEC + e] = to_f(from_f<T>(d));
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kMaxAcc; ++r) {
        const int idx = threadIdx.x + r * kThreads;
        if (idx < total) {
          const float* dp = ds + (idx / g.Co) * kEC;
          const float* wp = w2s + idx % g.Co;
          float a = acc[r];
          for (int ee = 0; ee < ec; ++ee) a = fmaf(dp[ee], wp[ee * g.Co], a);
          acc[r] = a;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    if (idx < total) {
      const int pix = idx / g.Co, co = idx % g.Co;
      const int hi = h0 + pix / g.tw, wi = w0 + pix % g.tw;
      if (hi < g.Ho && wi < g.Wo)
        out_frame[(size_t(hi) * g.Wo + wi) * g.Co + co] = from_f<T>(acc[r]);
    }
  }
}

// Output geometry and the largest tile (about 64 output pixels) whose
// shared memory and accumulators fit. Returns false if none does.
bool make_geom(Geom& g, int B, int T, int H, int W, int C, int E, int Co,
               int k, int s, int elem, bool main_pass, Layout* layout) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || C < 1 || E < 1 || k < 1 ||
      s < 1 || (main_pass && Co < 1))
    return false;
  g.B = B; g.T = T; g.H = H; g.W = W; g.C = C; g.E = E; g.Co = Co;
  g.k = k; g.s = s; g.p = k / 2;
  g.To = (T + 2 * g.p - 1) / s + 1;
  g.Ho = (H + 2 * g.p - k) / s + 1;
  g.Wo = (W + 2 * g.p - k) / s + 1;
  if (g.Ho < 1 || g.Wo < 1) return false;
  g.tw = g.Wo < 16 ? g.Wo : 16;
  g.th = 64 / g.tw < g.Ho ? 64 / g.tw : g.Ho;
  if (g.th < 1) g.th = 1;
  for (;;) {
    g.rows_in = (g.th - 1) * s + k;
    g.cols_in = (g.tw - 1) * s + k;
    *layout = make_layout(g, elem, main_pass);
    const bool acc_ok = !main_pass || g.th * g.tw * Co <= kMaxOutTile;
    if (layout->total <= kMaxSmem && acc_ok) break;
    if (g.th > 1) --g.th;
    else if (g.tw > 1) --g.tw;
    else return false;
  }
  g.n_tw = (g.Wo + g.tw - 1) / g.tw;
  g.n_tiles = ((g.Ho + g.th - 1) / g.th) * g.n_tw;
  return true;
}

template <typename T>
int launch_pool(const void* x, const void* w1, const void* wd, void* pooled,
                int B, int Tn, int H, int W, int C, int E, int k, int s,
                cudaStream_t stream) {
  Geom g;
  Layout l;
  if (!make_geom(g, B, Tn, H, W, C, E, 1, k, s, sizeof(T), false, &l))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(l.total));
  if (err != cudaSuccess) return int(err);
  dim3 grid((E + kEC - 1) / kEC, B);
  pool_kernel<T><<<grid, kThreads, l.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(wd), static_cast<float*>(pooled), g);
  return int(cudaGetLastError());
}

template <typename T>
int launch_main(const void* x, const void* w1, const void* wd,
                const void* w2, const float* scale, void* out, int B, int Tn,
                int H, int W, int C, int E, int Co, int k, int s,
                cudaStream_t stream) {
  Geom g;
  Layout l;
  if (!make_geom(g, B, Tn, H, W, C, E, Co, k, s, sizeof(T), true, &l))
    return int(cudaErrorInvalidValue);
  if (size_t(B) * g.To > 65535) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      main_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(l.total));
  if (err != cudaSuccess) return int(err);
  dim3 grid(g.n_tiles, B * g.To);
  main_kernel<T><<<grid, kThreads, l.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(wd), static_cast<const T*>(w2), scale,
      static_cast<T*>(out), g);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Returns 0, or the CUDA error of the launch (cudaErrorInvalidValue for a
// shape the kernels do not take).
extern "C" int fb_pool(const void* x, const void* w1, const void* wd,
                       void* pooled, int dtype, int B, int T, int H, int W,
                       int C, int E, int k, int s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pool<float>(x, w1, wd, pooled, B, T, H, W, C, E, k, s, st);
  if (dtype == 1)
    return launch_pool<__nv_bfloat16>(x, w1, wd, pooled, B, T, H, W, C, E,
                                      k, s, st);
  return int(cudaErrorInvalidValue);
}

extern "C" int fb_main(const void* x, const void* w1, const void* wd,
                       const void* w2, const void* scale, void* out,
                       int dtype, int B, int T, int H, int W, int C, int E,
                       int Co, int k, int s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    return launch_main<float>(x, w1, wd, w2, sc, out, B, T, H, W, C, E, Co,
                              k, s, st);
  if (dtype == 1)
    return launch_main<__nv_bfloat16>(x, w1, wd, w2, sc, out, B, T, H, W, C,
                                      E, Co, k, s, st);
  return int(cudaErrorInvalidValue);
}
