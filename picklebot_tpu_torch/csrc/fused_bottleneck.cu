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
// tile in VMEM. A Hopper block has at most 227 KB of shared memory, so a
// block owns one output tile of (th, tw) pixels and walks the expanded
// channels in chunks of kEC = 32: expand the input tile with its halo into
// f32 shared memory, apply the depthwise stencil at stride s in f32, and
// for the main pass scale it, round it to the input dtype and add its share
// of the projection into f32 accumulators for the (th*tw, Co) output tile.
// The tile (th, tw) and the split below come from the wrapper's plan
// (ops/fused_bottleneck.py _pool_plan, _main_plan); the launch checks the
// plan and refuses one whose shared memory or accumulators do not fit.
//
// bf16 (pool_bf16_kernel<K>, main_bf16_kernel<K>; K = 3 or 5 keeps the
// depthwise weights of a thread's channel in registers, K = 0 takes any k
// from shared memory): 256 threads, 8 warps.
//   1. x reaches shared memory as bf16 by 16-byte cp.async where C is a
//      multiple of 8 and the base is aligned (else by scalar loads): the
//      tile's pixels as rows, C padded to a multiple of 16 with zeros,
//      pixels outside the frame and rows past the tile as zero rows (exact:
//      the convs carry no bias). Rows are padded by 16 bytes so that
//      ldmatrix reads them without bank conflicts.
//   2. Expand on the tensor cores: (pixels x C) times the w1 chunk
//      (C x 32) on mma.sync m16n8k16 (ldmatrix for x, ldmatrix.trans for
//      w1 stored (C, E)); the f32 accumulators go to the f32 expanded tile.
//   3. The depthwise stencil on the FP32 pipe, one thread per (pixel
//      group, channel), taps dy outer, dx inner as in the Pallas kernel.
//   4. Pool pass: each thread sums its pixels, in item order; the eight
//      warps' sums are added in a fixed order at the end. Main pass: the
//      depthwise value times the scale, rounded to bf16 into a (pixels x
//      32) tile, then the projection on mma.sync into f32 fragments for
//      the whole (pixels x Co) output tile (Co padded to 16 with zero
//      columns of w2). The next chunk's w1, wd and w2 arrive by cp.async
//      into a second stage while this chunk is worked on.
// f32 (pool_f32_kernel, main_f32_kernel) stays on the FP32 pipe: TF32
// keeps about three decimal digits and would fail the f32 checks. Its
// products are FMA loops over f32 shared memory; one thread owns one
// expanded channel of a pixel group.
//
// The split. The pool pass's grid is one block per (sample, E-chunk);
// where that leaves the card short of blocks, each sample's list of
// (valid output frame, tile) items is cut into `splits` contiguous ranges:
// block index (b * E-chunks + chunk) * splits + split. Each block writes
// its f32 sums to a workspace (B, splits, E) and pool_split_sum_kernel
// adds the splits in order. The main pass's grid is one block per output
// tile; where it is short (small frames: 7x7, 14x14) the bf16 pass cuts
// the E-chunks into `splits` ordered ranges: block index (frame * tiles +
// tile) * splits + split; each block writes its f32 partial output tile
// to a workspace (splits, B*T'*H'*W', Co) and main_split_sum_kernel adds
// them in order and rounds once. No atomics: two calls give the same bits.
//
// The depthwise stencil's backward (dw_stencil_*, dw_dgrad_*, dw_wgrad_*,
// dw_wgrad_sum_kernel). These replace no TPU kernel: the JAX package's
// backward (_fb_bwd) is an XLA recompute of the plain chain, and so is
// the port's (FusedBottleneckFn.backward). They were added because that
// recompute's one op that is neither a matmul nor elementwise, the
// (1,k,k) depthwise conv with the stride on T, went to cuDNN's generic
// grouped conv3d: thousands of launches a block, layout transposes both
// ways, and a bf16 weight gradient 100-350x over the bound of all three
// passes together. The recompute now runs the stencil's forward, its
// input gradient (dx) and its weight gradient (dw) here, on the
// channels-last (B, T, H, W, E) tensors the chain already has.
//   What bounds them: bytes. Each pass reads the expanded tensor (or its
// gradient) and writes the other side once: 2*k*k FLOPs per output
// element against 4 bytes (bf16), under 13 FLOP/byte at k = 5, far under
// the ridge. dw writes only k*k*E values.
//   Design. A block owns a tile of pixels of one frame and a chunk of ec
// channels (16..64, from the plan; channels are the contiguous axis) and
// stages its input tile with the (k-1)-pixel halo in shared memory once,
// by 16-byte cp.async where E allows (else scalar), zero outside the
// frame. A thread owns a pair of channels (4 bytes of bf16, 8 of f32, so
// a warp reads consecutive words) and walks the tile's pixels, all k*k
// taps from shared memory, f32 accumulation, one rounding.
//   stencil: one output tile; output frames whose input frame lies
//     outside [0, T) (the T quirk's zero frames) are written as zeros.
//   dgrad:   one input tile; it stages the output-gradient rows the tile
//     reads and each pixel gathers from the at most ceil(k/s)^2 outputs
//     that read it: no scatter, no atomics. Input frames that no output
//     frame reads (t + k//2 not a multiple of s) are written as zeros.
//   wgrad:   a block takes its chunk over a contiguous range of the
//     (sample, valid output frame, output tile) items, the next item's
//     tiles arriving by cp.async while this one is worked on. A thread
//     keeps the k*k partial sums of its two channels in registers (K = 3
//     or 5: 18 or 50 floats; any other k keeps them in shared memory).
//     The block's pixel groups are added in a fixed order; with one range
//     the block writes dw rounded, else f32 partials (splits, k*k, E)
//     that dw_wgrad_sum_kernel adds in range order and rounds once: dw is
//     the same bits from run to run, as the pool pass's split is.
// The same templates serve bf16 and f32 (the f32 policy and the
// benchmark's f32 readings).
//
// Both grids are one-dimensional (grid.x takes up to 2^31 - 1 blocks, grid.y
// only 65,535), so no batch size the reference takes is refused.
//
// The temporal quirk of Bottleneck3D (temporal kernel 1, but the integer
// stride and the padding k//2 act on T) is index arithmetic: output frame t'
// reads input frame t'*s - k//2, and a frame outside [0, T) is all zero.
// That holds only because the convs carry no bias (the wrapper checks).
//
// Layouts (row-major, contiguous): x (B,T,H,W,C); w1 (C,E); wd (k*k,E);
// w2 (E,Co); scale (B,E) f32; pooled (B,E) f32; out (B,T',H',W',Co); the
// stencil's a and da (B,T,H,W,E), d and g (B,T',H',W',E), dw (k*k,E).
// x, weights and out share one dtype: float (dtype 0) or bf16 (dtype 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEC = 32;                      // expanded channels per chunk
constexpr int kGroups = kThreads / kEC;      // pixel groups per block
constexpr int kMaxAcc = 40;                  // f32: output accumulators/thread
constexpr int kMaxOutTile = kThreads * kMaxAcc;
constexpr int kMaxTiles = 10;                // bf16: m16n8 output tiles/warp
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kSumThreads = 256;
// bf16 shared-memory pitches (elements): rows padded by 16 bytes
constexpr int kW1Pitch = kEC + 8;            // w1 chunk (C, 32) bf16
constexpr int kEsPitch = kEC + 8;            // expanded tile (pixels, 32) f32
constexpr int kDsPitch = kEC + 8;            // projection operand bf16

struct Geom {
  int B, T, H, W, C, E, Co;
  int k, s, p;
  int To, Ho, Wo;
  int th, tw;             // output tile
  int rows_in, cols_in;   // input tile with its halo
  int n_tw, n_tiles;      // tiles along W, tiles per frame
  int to_first, n_valid;  // output frames that read an input frame
};

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~size_t(15);
}

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// ---------------------------------------------------------------------------
// f32: FMA loops over f32 shared memory
// ---------------------------------------------------------------------------

// Byte offsets of the shared-memory arrays (16-byte aligned), the same on
// host (for the launch size) and device.
struct Layout {
  size_t xs, w1s, wds, es, w2s, ds, red, total;
};

__host__ __device__ inline Layout make_layout(const Geom& g, bool main_pass) {
  Layout l;
  size_t q = size_t(g.rows_in) * g.cols_in;
  size_t o = 0;
  l.xs = o;  o = align16(o + q * g.C * 4);
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
__device__ void load_tile(const float* __restrict__ frame, float* xs,
                          const Geom& g, int h0, int w0) {
  const int hb = h0 * g.s - g.p, wb = w0 * g.s - g.p;
  const int n = g.rows_in * g.cols_in * g.C;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int c = idx % g.C, q = idx / g.C;
    const int hi = hb + q / g.cols_in, wi = wb + q % g.cols_in;
    float v = 0.f;
    if (hi >= 0 && hi < g.H && wi >= 0 && wi < g.W)
      v = frame[(size_t(hi) * g.W + wi) * g.C + c];
    xs[idx] = v;
  }
}

// Chunk [e0, e0+ec) of w1 and wd into shared memory; channels past ec are
// zero, so they expand and convolve to zero.
__device__ void load_w1_wd(const float* __restrict__ w1,
                           const float* __restrict__ wd, float* w1s,
                           float* wds, const Geom& g, int e0, int ec) {
  for (int idx = threadIdx.x; idx < g.C * kEC; idx += kThreads) {
    const int e = idx % kEC, c = idx / kEC;
    w1s[idx] = e < ec ? w1[size_t(c) * g.E + e0 + e] : 0.f;
  }
  for (int idx = threadIdx.x; idx < g.k * g.k * kEC; idx += kThreads) {
    const int e = idx % kEC, t = idx / kEC;
    wds[idx] = e < ec ? wd[size_t(t) * g.E + e0 + e] : 0.f;
  }
}

// Expand the input tile into es (rows_in*cols_in, kEC) f32. A thread owns
// channel e = tid % kEC, so a warp reads one broadcast x value and 32
// consecutive weights per step. Pixels outside the frame are zero without
// any arithmetic.
__device__ void expand(const float* xs, const float* w1s, float* es,
                       const Geom& g, int h0, int w0) {
  const int hb = h0 * g.s - g.p, wb = w0 * g.s - g.p;
  const int nq = g.rows_in * g.cols_in;
  const int e = threadIdx.x % kEC;
  for (int q = threadIdx.x / kEC; q < nq; q += kGroups) {
    const int hi = hb + q / g.cols_in, wi = wb + q % g.cols_in;
    float acc = 0.f;
    if (hi >= 0 && hi < g.H && wi >= 0 && wi < g.W) {
      const float* xq = xs + size_t(q) * g.C;
      for (int c = 0; c < g.C; ++c)
        acc = fmaf(xq[c], w1s[c * kEC + e], acc);
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

// The item range [lo, hi) of one split: a sample's (valid output frame,
// tile) items cut into `splits` contiguous ranges.
__device__ __forceinline__ void item_range(const Geom& g, int split,
                                           int splits, long long* lo,
                                           long long* hi) {
  const long long items = (long long)g.n_valid * g.n_tiles;
  *lo = items * split / splits;
  *hi = items * (split + 1) / splits;
}

__global__ void __launch_bounds__(kThreads)
pool_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ wd, float* __restrict__ pooled,
                float* __restrict__ part, Geom g, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(g, false);
  float* xs = reinterpret_cast<float*>(smem + l.xs);
  float* w1s = reinterpret_cast<float*>(smem + l.w1s);
  float* wds = reinterpret_cast<float*>(smem + l.wds);
  float* es = reinterpret_cast<float*>(smem + l.es);
  float* red = reinterpret_cast<float*>(smem + l.red);

  const int n_chunks = (g.E + kEC - 1) / kEC;
  const int split = blockIdx.x % splits, bc = blockIdx.x / splits;
  const int b = bc / n_chunks, e0 = (bc % n_chunks) * kEC;
  const int ec = min(kEC, g.E - e0);
  const int e = threadIdx.x % kEC, grp = threadIdx.x / kEC;
  long long lo, hi;
  item_range(g, split, splits, &lo, &hi);
  load_w1_wd(w1, wd, w1s, wds, g, e0, ec);
  float sum = 0.f;
  for (long long it = lo; it < hi; ++it) {
    const int to = g.to_first + int(it / g.n_tiles);
    const int tile = int(it % g.n_tiles);
    const int ti = to * g.s - g.p;
    const float* frame = x + (size_t(b) * g.T + ti) * g.H * g.W * g.C;
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
  red[grp * kEC + e] = sum;
  __syncthreads();
  if (threadIdx.x < ec) {
    float t = 0.f;
    for (int r = 0; r < kGroups; ++r) t += red[r * kEC + threadIdx.x];
    if (splits == 1)
      pooled[size_t(b) * g.E + e0 + threadIdx.x] = t;
    else
      part[(size_t(b) * splits + split) * g.E + e0 + threadIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
main_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ wd, const float* __restrict__ w2,
                const float* __restrict__ scale, float* __restrict__ out,
                Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(g, true);
  float* xs = reinterpret_cast<float*>(smem + l.xs);
  float* w1s = reinterpret_cast<float*>(smem + l.w1s);
  float* wds = reinterpret_cast<float*>(smem + l.wds);
  float* es = reinterpret_cast<float*>(smem + l.es);
  float* w2s = reinterpret_cast<float*>(smem + l.w2s);
  float* ds = reinterpret_cast<float*>(smem + l.ds);

  const int n = blockIdx.x / g.n_tiles, b = n / g.To, to = n % g.To;
  const int tile = blockIdx.x % g.n_tiles;
  const int h0 = (tile / g.n_tw) * g.th;
  const int w0 = (tile % g.n_tw) * g.tw;
  const int npix = g.th * g.tw, total = npix * g.Co;
  float* out_frame = out + size_t(n) * g.Ho * g.Wo * g.Co;
  const int ti = to * g.s - g.p;

  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;

  if (ti >= 0 && ti < g.T) {             // else a zero frame: output 0
    const float* frame = x + (size_t(b) * g.T + ti) * g.H * g.W * g.C;
    load_tile(frame, xs, g, h0, w0);
    const int e = threadIdx.x % kEC, grp = threadIdx.x / kEC;
    for (int e0 = 0; e0 < g.E; e0 += kEC) {
      const int ec = min(kEC, g.E - e0);
      __syncthreads();                   // previous chunk done with smem
      load_w1_wd(w1, wd, w1s, wds, g, e0, ec);
      for (int idx = threadIdx.x; idx < kEC * g.Co; idx += kThreads) {
        const int co = idx % g.Co, ee = idx / g.Co;
        w2s[idx] = ee < ec ? w2[size_t(e0 + ee) * g.Co + co] : 0.f;
      }
      __syncthreads();
      expand(xs, w1s, es, g, h0, w0);
      __syncthreads();
      const float sc = e < ec ? scale[size_t(b) * g.E + e0 + e] : 0.f;
      for (int pix = grp; pix < npix; pix += kGroups) {
        const int i = pix / g.tw, j = pix % g.tw;
        ds[pix * kEC + e] = depthwise(es, wds, g, i, j, e) * sc;
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
        out_frame[(size_t(hi) * g.Wo + wi) * g.Co + co] = acc[r];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false nothing is read and the 16
// bytes are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of the bf16 kernels: byte offsets and the padded sizes
// (elements). The main pass keeps one x tile and two stages of weight
// chunks; the pool pass two x tiles (the next item's arrives while this
// one is worked on) and one weight chunk.
struct LayoutB {
  int qp;                 // tile pixels (rows_in * cols_in) padded to 16
  int cp, xp;             // C padded to 16; x row pitch
  int pp;                 // output tile pixels padded to 16
  int co16, w2p;          // Co padded to 16; w2 row pitch
  size_t xs, w1s, wds, w2s, es, ds, red, total;
  size_t xs_stage, w1_stage, wd_stage, w2_stage;   // elements per stage
};

__host__ __device__ inline LayoutB make_layout_bf16(const Geom& g,
                                                    bool main_pass) {
  LayoutB l;
  l.qp = round16(g.rows_in * g.cols_in);
  l.cp = round16(g.C);
  l.xp = l.cp + 8;
  l.pp = round16(g.th * g.tw);
  l.co16 = round16(g.Co);
  l.w2p = l.co16 + 8;
  l.xs_stage = size_t(l.qp) * l.xp;
  l.w1_stage = size_t(l.cp) * kW1Pitch;
  l.wd_stage = size_t(g.k) * g.k * kEC;
  l.w2_stage = size_t(kEC) * l.w2p;
  const int x_stages = main_pass ? 1 : 2, w_stages = main_pass ? 2 : 1;
  size_t o = 0;
  l.xs = o;  o = align16(o + x_stages * l.xs_stage * 2);
  l.w1s = o; o = align16(o + w_stages * l.w1_stage * 2);
  l.wds = o; o = align16(o + w_stages * l.wd_stage * 2);
  l.w2s = o;
  if (main_pass) o = align16(o + 2 * l.w2_stage * 2);
  l.es = o;  o = align16(o + size_t(l.qp) * kEsPitch * 4);
  l.ds = l.red = o;
  o = main_pass ? align16(o + size_t(l.pp) * kDsPitch * 2)
                : align16(o + size_t(kWarps) * kEC * 4);
  l.total = o;
  return l;
}

// Input tile with halo for output tile origin (h0, w0) into xs (qp rows of
// pitch xp): C..cp-1, pixels outside the frame and rows past the tile are
// zero. 16-byte cp.async where vec (C % 8 == 0, x aligned), else scalar.
__device__ void load_tile_bf16(const bf16* __restrict__ frame, bf16* xs,
                               const Geom& g, const LayoutB& l, int h0,
                               int w0, bool vec) {
  const int hb = h0 * g.s - g.p, wb = w0 * g.s - g.p;
  const int nq = g.rows_in * g.cols_in, pieces = l.cp / 8;
  const bf16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < l.qp * pieces; idx += kThreads) {
    const int q = idx / pieces, c = (idx % pieces) * 8;
    const int hi = hb + q / g.cols_in, wi = wb + q % g.cols_in;
    const bool pos = q < nq && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W;
    const bf16* src =
        pos ? frame + (size_t(hi) * g.W + wi) * g.C + c : frame;
    bf16* dst = xs + q * l.xp + c;
    if (vec) {
      const bool ok = pos && c < g.C;
      cp_async16(smem_addr(dst), src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = pos && c + j < g.C ? src[j] : zero;
    }
  }
}

// Chunk [e0, e0 + 32) of w1 (as (cp, 32), pitch kW1Pitch) and of wd (as
// (k*k, 32)); channels past E and rows past C are zero.
__device__ void load_w1_wd_bf16(const bf16* __restrict__ w1,
                                const bf16* __restrict__ wd, bf16* w1s,
                                bf16* wds, const Geom& g, const LayoutB& l,
                                int e0, bool vec) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < l.cp * 4; idx += kThreads) {
    const int c = idx >> 2, e = e0 + (idx & 3) * 8;
    bf16* dst = w1s + c * kW1Pitch + (idx & 3) * 8;
    const bf16* src = w1 + size_t(c) * g.E + e;
    if (vec) {
      const bool ok = c < g.C && e < g.E;
      cp_async16(smem_addr(dst), ok ? src : w1, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = c < g.C && e + j < g.E ? src[j] : zero;
    }
  }
  for (int idx = threadIdx.x; idx < g.k * g.k * 4; idx += kThreads) {
    const int t = idx >> 2, e = e0 + (idx & 3) * 8;
    bf16* dst = wds + t * kEC + (idx & 3) * 8;
    const bf16* src = wd + size_t(t) * g.E + e;
    if (vec) {
      const bool ok = e < g.E;
      cp_async16(smem_addr(dst), ok ? src : wd, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = e + j < g.E ? src[j] : zero;
    }
  }
}

// Rows [e0, e0 + 32) of w2 as (32, co16), pitch w2p; rows past E and
// columns past Co are zero.
__device__ void load_w2_bf16(const bf16* __restrict__ w2, bf16* w2s,
                             const Geom& g, const LayoutB& l, int e0,
                             bool vec) {
  const bf16 zero = __float2bfloat16(0.f);
  const int pieces = l.co16 / 8;
  for (int idx = threadIdx.x; idx < kEC * pieces; idx += kThreads) {
    const int ee = idx / pieces, co = (idx % pieces) * 8;
    bf16* dst = w2s + ee * l.w2p + co;
    const bf16* src = w2 + size_t(e0 + ee) * g.Co + co;
    const bool row = e0 + ee < g.E;
    if (vec) {
      const bool ok = row && co < g.Co;
      cp_async16(smem_addr(dst), ok ? src : w2, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = row && co + j < g.Co ? src[j] : zero;
    }
  }
}

// es (qp, 32) f32 = xs (qp, cp) x w1s (cp, 32) on mma.sync; warp w takes
// the m16 row tiles w, w + 8, ...
__device__ __forceinline__ void expand_mma(const bf16* xs, const bf16* w1s,
                                           float* es, const LayoutB& l) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t a_base =
      smem_addr(xs) + ((lane & 15) * l.xp + (lane >> 4) * 8) * 2;
  const uint32_t b_base =
      smem_addr(w1s) + ((lane & 15) * kW1Pitch + (lane >> 4) * 8) * 2;
  const int kc = l.cp / 16;
  for (int mt = warp; mt < l.qp / 16; mt += kWarps) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
    const uint32_t a_row = a_base + mt * 16 * l.xp * 2;
    for (int kk = 0; kk < kc; ++kk) {
      uint32_t af[4], b01[4], b23[4];
      ldmatrix_x4(af, a_row + kk * 32);
      ldmatrix_x4_trans(b01, b_base + kk * 16 * kW1Pitch * 2);
      ldmatrix_x4_trans(b23, b_base + (kk * 16 * kW1Pitch + 16) * 2);
      mma_bf16(acc[0], af, b01[0], b01[1]);
      mma_bf16(acc[1], af, b01[2], b01[3]);
      mma_bf16(acc[2], af, b23[0], b23[1]);
      mma_bf16(acc[3], af, b23[2], b23[3]);
    }
    // rows lane/4 and lane/4 + 8, columns 2*(lane%4) and +1 of each n8
    float* r0 = es + (mt * 16 + (lane >> 2)) * kEsPitch + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<float2*>(r0 + nt * 8) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(r0 + 8 * kEsPitch + nt * 8) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// The depthwise weights of channel e for one chunk: in registers for K > 0,
// read from shared memory per tap for K = 0 (any k).
template <int K>
struct DwWeights {
  float w[K > 0 ? K * K : 1];
  __device__ __forceinline__ void load(const bf16* wds, int e) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) w[t] = __bfloat162float(wds[t * kEC + e]);
  }
};

// Depthwise (1,k,k) stencil at stride s for tile pixel (i, j), channel e,
// in f32 (same tap order as the Pallas kernel: dy outer, dx inner).
template <int K>
__device__ __forceinline__ float depthwise_bf16(const float* es,
                                                const DwWeights<K>& wr,
                                                const bf16* wds,
                                                const Geom& g, int i, int j,
                                                int e) {
  const int k = K > 0 ? K : g.k;
  const float* base = es + ((i * g.s) * g.cols_in + j * g.s) * kEsPitch + e;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < k; ++dy) {
    const float* row = base + dy * g.cols_in * kEsPitch;
#pragma unroll
    for (int dx = 0; dx < k; ++dx) {
      float w;
      if constexpr (K > 0)
        w = wr.w[dy * K + dx];
      else
        w = __bfloat162float(wds[(dy * k + dx) * kEC + e]);
      acc = fmaf(row[dx * kEsPitch], w, acc);
    }
  }
  return acc;
}

// Tile pixel pix = i * tw + j, stepped by a fixed count: no division per
// pixel.
struct TilePix {
  int i, j;
  __device__ __forceinline__ TilePix(int pix, int tw)
      : i(pix / tw), j(pix % tw) {}
  __device__ __forceinline__ void advance(int by, int tw) {
    j += by;
    while (j >= tw) { j -= tw; ++i; }
  }
};

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
pool_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ wd, float* __restrict__ pooled,
                 float* __restrict__ part, Geom g, int splits, int vec_x,
                 int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutB l = make_layout_bf16(g, false);
  bf16* xs = reinterpret_cast<bf16*>(smem + l.xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + l.w1s);
  bf16* wds = reinterpret_cast<bf16*>(smem + l.wds);
  float* es = reinterpret_cast<float*>(smem + l.es);
  float* red = reinterpret_cast<float*>(smem + l.red);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (g.E + kEC - 1) / kEC;
  const int split = blockIdx.x % splits, bc = blockIdx.x / splits;
  const int b = bc / n_chunks, e0 = (bc % n_chunks) * kEC;
  const int ec = min(kEC, g.E - e0);
  const bf16* xb = x + size_t(b) * g.T * g.H * g.W * g.C;
  long long lo, hi;
  item_range(g, split, splits, &lo, &hi);

  // item it: valid output frame to_first + it / n_tiles, tile it % n_tiles
  auto load_item = [&](long long it, int buf) {
    const int to = g.to_first + int(it / g.n_tiles);
    const int tile = int(it % g.n_tiles);
    load_tile_bf16(xb + size_t(to * g.s - g.p) * g.H * g.W * g.C,
                   xs + buf * l.xs_stage, g, l, (tile / g.n_tw) * g.th,
                   (tile % g.n_tw) * g.tw, vec_x);
  };

  load_w1_wd_bf16(w1, wd, w1s, wds, g, l, e0, vec_w);
  if (lo < hi) load_item(lo, 0);
  cp_async_commit();
  DwWeights<K> wr;
  float sum = 0.f, sum2 = 0.f;
  const int npix = g.th * g.tw;
  for (long long it = lo; it < hi; ++it) {
    const int buf = int(it - lo) & 1;
    if (it + 1 < hi) load_item(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                // this item's tile has landed ...
    __syncthreads();                   // ... for every thread; es is free
    if (it == lo) wr.load(wds, lane);
    expand_mma(xs + buf * l.xs_stage, w1s, es, l);
    __syncthreads();
    const int tile = int(it % g.n_tiles);
    const int h0 = (tile / g.n_tw) * g.th, w0 = (tile % g.n_tw) * g.tw;
    // pixels warp, warp + 8, ... two at a time: two independent chains
    TilePix a(warp, g.tw), b(warp + kWarps, g.tw);
    for (int pix = warp; pix < npix; pix += 2 * kWarps) {
      if (h0 + a.i < g.Ho && w0 + a.j < g.Wo)
        sum += depthwise_bf16<K>(es, wr, wds, g, a.i, a.j, lane);
      if (pix + kWarps < npix && h0 + b.i < g.Ho && w0 + b.j < g.Wo)
        sum2 += depthwise_bf16<K>(es, wr, wds, g, b.i, b.j, lane);
      a.advance(2 * kWarps, g.tw);
      b.advance(2 * kWarps, g.tw);
    }
  }
  cp_async_wait<0>();
  red[warp * kEC + lane] = sum + sum2;
  __syncthreads();
  if (threadIdx.x < ec) {
    float t = 0.f;
    for (int r = 0; r < kWarps; ++r) t += red[r * kEC + threadIdx.x];
    if (splits == 1)
      pooled[size_t(b) * g.E + e0 + threadIdx.x] = t;
    else
      part[(size_t(b) * splits + split) * g.E + e0 + threadIdx.x] = t;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
main_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ wd, const bf16* __restrict__ w2,
                 const float* __restrict__ scale, bf16* __restrict__ out,
                 float* __restrict__ part, Geom g, int splits, int vec_x,
                 int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutB l = make_layout_bf16(g, true);
  bf16* xs = reinterpret_cast<bf16*>(smem + l.xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + l.w1s);
  bf16* wds = reinterpret_cast<bf16*>(smem + l.wds);
  bf16* w2s = reinterpret_cast<bf16*>(smem + l.w2s);
  float* es = reinterpret_cast<float*>(smem + l.es);
  bf16* ds = reinterpret_cast<bf16*>(smem + l.ds);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x % splits, rest = blockIdx.x / splits;
  const int tile = rest % g.n_tiles, n = rest / g.n_tiles;
  const int b = n / g.To, to = n % g.To;
  const int h0 = (tile / g.n_tw) * g.th, w0 = (tile % g.n_tw) * g.tw;
  const int npix = g.th * g.tw;
  const int nn = l.co16 / 8, n_out = (l.pp / 16) * nn;
  const int n_chunks = (g.E + kEC - 1) / kEC;
  const int c_lo = split * n_chunks / splits;
  const int c_hi = (split + 1) * n_chunks / splits;
  const int ti = to * g.s - g.p;

  float acc[kMaxTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  auto load_chunk = [&](int c, int st) {
    load_w1_wd_bf16(w1, wd, w1s + st * l.w1_stage, wds + st * l.wd_stage, g,
                    l, c * kEC, vec_w);
    load_w2_bf16(w2, w2s + st * l.w2_stage, g, l, c * kEC, vec_w);
  };

  if (ti >= 0 && ti < g.T) {             // else a zero frame: output 0
    load_tile_bf16(x + (size_t(b) * g.T + ti) * g.H * g.W * g.C, xs, g, l,
                   h0, w0, vec_x);
    load_chunk(c_lo, 0);
    cp_async_commit();
    for (int c = c_lo; c < c_hi; ++c) {
      const int st = (c - c_lo) & 1;
      const int e = c * kEC + lane;
      const float sc = e < g.E ? scale[size_t(b) * g.E + e] : 0.f;
      cp_async_wait<0>();                // this chunk (and x) has landed ...
      __syncthreads();                   // ... for every thread, and the
                                         // last chunk's reads are done
      if (c + 1 < c_hi) load_chunk(c + 1, st ^ 1);
      cp_async_commit();
      expand_mma(xs, w1s + st * l.w1_stage, es, l);
      __syncthreads();
      // f32 through the stencil and the scale; rounded to bf16 only as the
      // projection's operand (as in the Pallas kernel). Pixels warp,
      // warp + 8, ... two at a time (pp is a multiple of 16)
      const bf16* wds_c = wds + st * l.wd_stage;
      DwWeights<K> wr;
      wr.load(wds_c, lane);
      TilePix pa(warp, g.tw), pb(warp + kWarps, g.tw);
      for (int pix = warp; pix < l.pp; pix += 2 * kWarps) {
        float d0 = 0.f, d1 = 0.f;
        if (pix < npix)
          d0 = depthwise_bf16<K>(es, wr, wds_c, g, pa.i, pa.j, lane);
        if (pix + kWarps < npix)
          d1 = depthwise_bf16<K>(es, wr, wds_c, g, pb.i, pb.j, lane);
        ds[pix * kDsPitch + lane] = __float2bfloat16(d0 * sc);
        ds[(pix + kWarps) * kDsPitch + lane] = __float2bfloat16(d1 * sc);
        pa.advance(2 * kWarps, g.tw);
        pb.advance(2 * kWarps, g.tw);
      }
      __syncthreads();
      // out tile (pp, co16) += ds (pp, 32) x w2s (32, co16); warp w takes
      // the m16n8 tiles w, w + 8, ...
      const uint32_t a_base =
          smem_addr(ds) + ((lane & 15) * kDsPitch + (lane >> 4) * 8) * 2;
      const uint32_t b_base =
          smem_addr(w2s + st * l.w2_stage) + (lane & 15) * l.w2p * 2;
#pragma unroll
      for (int j = 0; j < kMaxTiles; ++j) {
        const int t = warp + kWarps * j;
        if (t < n_out) {
          const int mt = t / nn, nt = t % nn;
#pragma unroll
          for (int kk = 0; kk < kEC / 16; ++kk) {
            uint32_t af[4], b0, b1;
            ldmatrix_x4(af, a_base + (mt * 16 * kDsPitch + kk * 16) * 2);
            ldmatrix_x2_trans(b0, b1,
                              b_base + (kk * 16 * l.w2p + nt * 8) * 2);
            mma_bf16(acc[j], af, b0, b1);
          }
        }
      }
    }
  }

  // epilogue: rows lane/4 and lane/4 + 8 of each m16 tile, columns
  // 2*(lane%4) and +1 of each n8 tile; pairs stored together where Co is
  // even (then a pair never straddles Co)
  const bool pairs = (g.Co & 1) == 0;
  const size_t m_co = size_t(g.B) * g.To * g.Ho * g.Wo * g.Co;
  float* part_s = part + split * m_co;
  const size_t frame_off = size_t(n) * g.Ho * g.Wo * g.Co;
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j) {
    const int t = warp + kWarps * j;
    if (t >= n_out) continue;
    const int mt = t / nn, nt = t % nn;
    const int co = nt * 8 + 2 * (lane & 3);
    if (co >= g.Co) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = mt * 16 + (lane >> 2) + 8 * half;
      if (pix >= npix) continue;
      const int hi = h0 + pix / g.tw, wi = w0 + pix % g.tw;
      if (hi >= g.Ho || wi >= g.Wo) continue;
      const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
      const size_t o = frame_off + (size_t(hi) * g.Wo + wi) * g.Co + co;
      if (splits > 1) {
        if (pairs) {
          *reinterpret_cast<float2*>(part_s + o) = make_float2(v0, v1);
        } else {
          part_s[o] = v0;
          if (co + 1 < g.Co) part_s[o + 1] = v1;
        }
      } else if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(out + o) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        out[o] = __float2bfloat16(v0);
        if (co + 1 < g.Co) out[o + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// pooled[b][e] = part[b][0][e] + part[b][1][e] + ... + part[b][splits-1][e],
// in that order
__global__ void __launch_bounds__(kSumThreads)
pool_split_sum_kernel(const float* __restrict__ part,
                      float* __restrict__ pooled, int B, int E, int splits) {
  const long long n = (long long)B * E;
  for (long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kSumThreads) {
    const float* p = part + (i / E) * splits * E + i % E;
    float s = p[0];
    for (int k = 1; k < splits; ++k) s += p[size_t(k) * E];
    pooled[i] = s;
  }
}

// out[i] = round(part[0][i] + part[1][i] + ... + part[splits-1][i]), in
// that order
__global__ void __launch_bounds__(kSumThreads)
main_split_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                      long long n, int splits) {
  for (long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kSumThreads) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[k * n + i];
    out[i] = __float2bfloat16(s);
  }
}

// ---------------------------------------------------------------------------
// the depthwise stencil's backward: stencil, dgrad, wgrad (bf16 and f32)
// ---------------------------------------------------------------------------

constexpr int kMaxDwChunk = 64;

enum DwKind { kStencil = 0, kDgrad = 1, kWgrad = 2 };

struct DwGeom {
  int B, T, H, W, E, k, s, p;
  int To, Ho, Wo;
  int th, tw;             // tile: output pixels (stencil, wgrad), input
                          // pixels (dgrad)
  int ec, n_chunks;       // channels per chunk, chunks
  int tpp, groups;        // threads per pixel (ec / 2), pixel groups
  int rows, cols;         // the staged tile: the input with its halo
                          // (stencil, wgrad), the gradient rows (dgrad)
  int n_tw, n_tiles;      // tiles along W, tiles per frame
  int to_first, n_valid;  // output frames that read an input frame
};

// Rows of the staged tile for a tile of n pixels along one axis.
__host__ __device__ inline int dw_span(int n, int k, int s, int kind) {
  if (kind != kDgrad) return (n - 1) * s + k;
  // output rows floor((h0+p-k+1)/s) .. floor((h0+n-1+p)/s): at most this
  return s == 1 ? n + k - 1 : (n + k - 2) / s + 2;
}

// Byte offsets of a dw kernel's shared memory (16-byte aligned); the
// wrapper's plan mirrors it (ops/fused_bottleneck.py _dw_smem).
struct DwLayout {
  size_t xs, gs, red, acc, total;
  size_t xs_stage, gs_stage;          // elements per stage
};

__host__ __device__ inline DwLayout make_dw_layout(const DwGeom& g, int kind,
                                                   int elem) {
  DwLayout l;
  l.xs_stage = size_t(g.rows) * g.cols * g.ec;
  l.gs_stage = size_t(g.th) * g.tw * g.ec;
  size_t o = 0;
  l.xs = o;
  if (kind != kWgrad) {
    o = align16(o + l.xs_stage * elem);
    l.gs = l.red = l.acc = o;
  } else {
    o = align16(o + l.xs_stage * elem);
    o = align16(o + l.xs_stage * elem);     // the second stage
    l.gs = o;
    o = align16(o + 2 * l.gs_stage * elem);
    l.red = o;
    o = align16(o + size_t(g.groups) * g.ec * 4);
    l.acc = o;
    if (g.k != 3 && g.k != 5)              // wgrad's sums, any other k
      o = align16(o + size_t(g.k) * g.k * kThreads * 8);
  }
  l.total = o;
  return l;
}

// A pair of channels as float2, and the element type's conversions.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float2 get2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void put2(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};

template <>
struct Elem<bf16> {
  static __device__ __forceinline__ float2 get2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void put2(bf16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
  static __device__ __forceinline__ float to_f(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from_f(float v) {
    return __float2bfloat16(v);
  }
};

// Channels e, e + 1 of one pixel (dst points at channel e), rounded once;
// as one store where `pairs` (E even, base aligned), else by element.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, int e, int E, float2 v,
                                           bool pairs) {
  if (pairs && e + 1 < E) {
    Elem<T>::put2(dst, v);
  } else {
    if (e < E) dst[0] = Elem<T>::from_f(v.x);
    if (e + 1 < E) dst[1] = Elem<T>::from_f(v.y);
  }
}

// The weight pair of tap t for channels e, e + 1 (zero past E).
template <typename T>
__device__ __forceinline__ float2 dw_weight(const T* __restrict__ wd,
                                           const DwGeom& g, int t, int e) {
  const T* w = wd + size_t(t) * g.E + e;
  return make_float2(e < g.E ? Elem<T>::to_f(w[0]) : 0.f,
                     e + 1 < g.E ? Elem<T>::to_f(w[1]) : 0.f);
}

// rows x cols pixels of one (nr, nc) frame from pixel (r0, c0) on (either
// may be negative), channels [e0, e0 + ec), into sh (pixel-major, ec a
// pixel); zero outside the frame and past E. 16-byte cp.async where vec
// (E * sizeof(T) a multiple of 16, base aligned), else scalar.
template <typename T>
__device__ void load_dw_tile(const T* __restrict__ frame, T* sh,
                             const DwGeom& g, int nr, int nc, int r0, int c0,
                             int rows, int cols, int e0, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int pieces = g.ec / V, n = rows * cols * pieces;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int q = idx / pieces, c = (idx - q * pieces) * V;
    const int qr = q / cols;
    const int r = r0 + qr, cc = c0 + (q - qr * cols);
    const bool pos = r >= 0 && r < nr && cc >= 0 && cc < nc;
    const T* src = pos ? frame + (size_t(r) * nc + cc) * g.E + e0 + c : frame;
    T* dst = sh + size_t(q) * g.ec + c;
    if (vec) {
      cp_async16(smem_addr(dst), src, pos && e0 + c < g.E);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        dst[j] = pos && e0 + c + j < g.E ? src[j] : Elem<T>::from_f(0.f);
    }
  }
}

// r = q * s exactly? (q = r / s); s is the same for the whole block
__device__ __forceinline__ bool on_stride(int r, int s, int& q) {
  if (s == 1) { q = r; return true; }
  if (s == 2) { q = r >> 1; return (r & 1) == 0; }
  q = r / s;
  return r == q * s;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// d[b,t',h',w',e] = sum_{i,j} a[b, t's-p, h's-p+i, w's-p+j, e] wd[i,j,e].
// Block: (chunk, output frame, tile), tile fastest.
template <typename T, int K>
__device__ __forceinline__ void dw_stencil_body(const T* __restrict__ a,
                                                const T* __restrict__ wd,
                                                T* __restrict__ out,
                                                const DwGeom& g, bool vec,
                                                bool pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int k = K > 0 ? K : g.k;
  const int tile = blockIdx.x % g.n_tiles, rest = blockIdx.x / g.n_tiles;
  const int n = rest % (g.B * g.To), chunk = rest / (g.B * g.To);
  const int b = n / g.To, to = n % g.To, ti = to * g.s - g.p;
  const int e0 = chunk * g.ec;
  const int h0 = (tile / g.n_tw) * g.th, w0 = (tile % g.n_tw) * g.tw;
  const bool frame_in = ti >= 0 && ti < g.T;    // else a zero frame
  if (frame_in) {
    load_dw_tile(a + (size_t(b) * g.T + ti) * g.H * g.W * g.E, xs, g, g.H,
                 g.W, h0 * g.s - g.p, w0 * g.s - g.p, g.rows, g.cols, e0, vec);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  const int grp = threadIdx.x / g.tpp, el = 2 * (threadIdx.x % g.tpp);
  if (grp >= g.groups) return;
  const int e = e0 + el;
  float2 w[K > 0 ? K * K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) w[t] = dw_weight(wd, g, t, e);
  }
  T* out_frame = out + size_t(n) * g.Ho * g.Wo * g.E + e;
  for (int pix = grp; pix < g.th * g.tw; pix += g.groups) {
    const int i = pix / g.tw, j = pix - i * g.tw;
    if (h0 + i >= g.Ho || w0 + j >= g.Wo) continue;
    float2 acc = make_float2(0.f, 0.f);
    if (frame_in) {
      const T* base = xs + size_t(i * g.s * g.cols + j * g.s) * g.ec + el;
#pragma unroll
      for (int dy = 0; dy < k; ++dy) {
        const T* row = base + size_t(dy) * g.cols * g.ec;
#pragma unroll
        for (int dx = 0; dx < k; ++dx) {
          const float2 v = Elem<T>::get2(row + dx * g.ec);
          float2 wt;
          if constexpr (K > 0)
            wt = w[dy * K + dx];
          else
            wt = dw_weight(wd, g, dy * k + dx, e);
          acc.x = fmaf(v.x, wt.x, acc.x);
          acc.y = fmaf(v.y, wt.y, acc.y);
        }
      }
    }
    store_pair(out_frame + (size_t(h0 + i) * g.Wo + w0 + j) * g.E, e, g.E,
               acc, pairs);
  }
}

// da[b,t,h,w,e] = sum over the taps (i,j) with h+p-i = h's, w+p-j = w's
// (s divides both) of g[b,t',h',w',e] wd[i,j,e], where t' = (t+p)/s;
// zero where s does not divide t+p. Block: (chunk, input frame, tile).
template <typename T, int K>
__device__ __forceinline__ void dw_dgrad_body(const T* __restrict__ gr,
                                              const T* __restrict__ wd,
                                              T* __restrict__ da,
                                              const DwGeom& g, bool vec,
                                              bool pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* gs = reinterpret_cast<T*>(smem);
  const int k = K > 0 ? K : g.k;
  const int tile = blockIdx.x % g.n_tiles, rest = blockIdx.x / g.n_tiles;
  const int n = rest % (g.B * g.T), chunk = rest / (g.B * g.T);
  const int b = n / g.T, ti = n % g.T;
  const int e0 = chunk * g.ec;
  const int h0 = (tile / g.n_tw) * g.th, w0 = (tile % g.n_tw) * g.tw;
  int to;
  // t + p >= 0, and (t + p) / s < T' for every t < T
  const bool read = on_stride(ti + g.p, g.s, to);
  const int gh0 = floor_div(h0 + g.p - k + 1, g.s);
  const int gw0 = floor_div(w0 + g.p - k + 1, g.s);
  if (read) {
    load_dw_tile(gr + (size_t(b) * g.To + to) * g.Ho * g.Wo * g.E, gs, g,
                 g.Ho, g.Wo, gh0, gw0, g.rows, g.cols, e0, vec);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  const int grp = threadIdx.x / g.tpp, el = 2 * (threadIdx.x % g.tpp);
  if (grp >= g.groups) return;
  const int e = e0 + el;
  float2 w[K > 0 ? K * K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) w[t] = dw_weight(wd, g, t, e);
  }
  T* da_frame = da + size_t(n) * g.H * g.W * g.E + e;
  for (int pix = grp; pix < g.th * g.tw; pix += g.groups) {
    const int i = pix / g.tw, j = pix - i * g.tw;
    const int hi = h0 + i, wi = w0 + j;
    if (hi >= g.H || wi >= g.W) continue;
    float2 acc = make_float2(0.f, 0.f);
    if (read) {
      // tile rows of output row h' = (hi + p - dy) / s, counted from gh0
      const int rh = hi + g.p - gh0 * g.s, rw = wi + g.p - gw0 * g.s;
#pragma unroll
      for (int dy = 0; dy < k; ++dy) {
        int qy;
        if (!on_stride(rh - dy, g.s, qy)) continue;
        const T* row = gs + size_t(qy) * g.cols * g.ec + el;
#pragma unroll
        for (int dx = 0; dx < k; ++dx) {
          int qx;
          if (!on_stride(rw - dx, g.s, qx)) continue;
          const float2 v = Elem<T>::get2(row + qx * g.ec);
          float2 wt;
          if constexpr (K > 0)
            wt = w[dy * K + dx];
          else
            wt = dw_weight(wd, g, dy * k + dx, e);
          acc.x = fmaf(v.x, wt.x, acc.x);
          acc.y = fmaf(v.y, wt.y, acc.y);
        }
      }
    }
    store_pair(da_frame + (size_t(hi) * g.W + wi) * g.E, e, g.E, acc, pairs);
  }
}

// dw[i,j,e] = sum over the valid output positions (b,t',h',w') of
// g[b,t',h',w',e] a[b, t's-p, h's-p+i, w's-p+j, e], per block over one
// range of the (sample, valid frame, tile) items; blockIdx.x = chunk *
// splits + split.
template <typename T, int K>
__device__ __forceinline__ void dw_wgrad_body(const T* __restrict__ a,
                                              const T* __restrict__ gr,
                                              T* __restrict__ dwd,
                                              float* __restrict__ part,
                                              const DwGeom& g, int splits,
                                              bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DwLayout l = make_dw_layout(g, kWgrad, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem + l.xs);
  T* gs = reinterpret_cast<T*>(smem + l.gs);
  float* red = reinterpret_cast<float*>(smem + l.red);
  float2* accs = reinterpret_cast<float2*>(smem + l.acc);
  const int k = K > 0 ? K : g.k, kk = k * k;
  const int split = blockIdx.x % splits, chunk = blockIdx.x / splits;
  const int e0 = chunk * g.ec;
  const long long per_b = (long long)g.n_valid * g.n_tiles;
  const long long items = g.B * per_b;
  const long long lo = items * split / splits;
  const long long hi = items * (split + 1) / splits;
  const int grp = threadIdx.x / g.tpp, el = 2 * (threadIdx.x % g.tpp);
  const bool active = grp < g.groups;

  auto load_item = [&](long long it, int buf) {
    const int b = int(it / per_b), rem = int(it % per_b);
    const int to = g.to_first + rem / g.n_tiles, tile = rem % g.n_tiles;
    const int h0 = (tile / g.n_tw) * g.th, w0 = (tile % g.n_tw) * g.tw;
    load_dw_tile(a + (size_t(b) * g.T + to * g.s - g.p) * g.H * g.W * g.E,
                 xs + buf * l.xs_stage, g, g.H, g.W, h0 * g.s - g.p,
                 w0 * g.s - g.p, g.rows, g.cols, e0, vec);
    load_dw_tile(gr + (size_t(b) * g.To + to) * g.Ho * g.Wo * g.E,
                 gs + buf * l.gs_stage, g, g.Ho, g.Wo, h0, w0, g.th, g.tw,
                 e0, vec);
  };

  float2 acc[K > 0 ? K * K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) acc[t] = make_float2(0.f, 0.f);
  } else {
    for (int t = 0; t < kk; ++t)
      accs[t * kThreads + threadIdx.x] = make_float2(0.f, 0.f);
  }
  if (lo < hi) load_item(lo, 0);
  cp_async_commit();
  for (long long it = lo; it < hi; ++it) {
    const int buf = int(it - lo) & 1;
    if (it + 1 < hi) load_item(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                // this item's tiles have landed ...
    __syncthreads();                   // ... for every thread
    const int tile = int(it % per_b) % g.n_tiles;
    const int h0 = (tile / g.n_tw) * g.th, w0 = (tile % g.n_tw) * g.tw;
    const T* xb = xs + buf * l.xs_stage + el;
    const T* gb = gs + buf * l.gs_stage + el;
    for (int pix = grp; active && pix < g.th * g.tw; pix += g.groups) {
      const int i = pix / g.tw, j = pix - i * g.tw;
      if (h0 + i >= g.Ho || w0 + j >= g.Wo) continue;
      const float2 gv = Elem<T>::get2(gb + size_t(pix) * g.ec);
      const T* base = xb + size_t(i * g.s * g.cols + j * g.s) * g.ec;
#pragma unroll
      for (int dy = 0; dy < k; ++dy) {
#pragma unroll
        for (int dx = 0; dx < k; ++dx) {
          const float2 v =
              Elem<T>::get2(base + size_t(dy * g.cols + dx) * g.ec);
          if constexpr (K > 0) {
            float2& r = acc[dy * K + dx];
            r.x = fmaf(gv.x, v.x, r.x);
            r.y = fmaf(gv.y, v.y, r.y);
          } else {
            float2& r = accs[(dy * k + dx) * kThreads + threadIdx.x];
            r.x = fmaf(gv.x, v.x, r.x);
            r.y = fmaf(gv.y, v.y, r.y);
          }
        }
      }
    }
    __syncthreads();                   // done with buf before it refills
  }
  cp_async_wait<0>();
  // the pixel groups' sums, tap by tap, added in group order
  auto reduce_tap = [&](int t, float2 v) {
    if (active) {
      red[grp * g.ec + el] = v.x;
      red[grp * g.ec + el + 1] = v.y;
    }
    __syncthreads();
    if (threadIdx.x < g.ec) {
      float s = 0.f;
      for (int r = 0; r < g.groups; ++r) s += red[r * g.ec + threadIdx.x];
      const int e = e0 + threadIdx.x;
      if (e < g.E) {
        if (splits == 1)
          dwd[size_t(t) * g.E + e] = Elem<T>::from_f(s);
        else
          part[(size_t(split) * kk + t) * g.E + e] = s;
      }
    }
    __syncthreads();
  };
  if constexpr (K > 0) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) reduce_tap(t, acc[t]);
  } else {
    for (int t = 0; t < kk; ++t)
      reduce_tap(t, accs[t * kThreads + threadIdx.x]);
  }
}

// The kernels by name (dtype in the name, as the file's others): each
// is its template body.
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
dw_stencil_bf16_kernel(const bf16* a, const bf16* wd, bf16* out, DwGeom g,
                       int vec, int pairs) {
  dw_stencil_body<bf16, K>(a, wd, out, g, vec, pairs);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
dw_stencil_f32_kernel(const float* a, const float* wd, float* out, DwGeom g,
                      int vec, int pairs) {
  dw_stencil_body<float, K>(a, wd, out, g, vec, pairs);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
dw_dgrad_bf16_kernel(const bf16* gr, const bf16* wd, bf16* da, DwGeom g,
                     int vec, int pairs) {
  dw_dgrad_body<bf16, K>(gr, wd, da, g, vec, pairs);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
dw_dgrad_f32_kernel(const float* gr, const float* wd, float* da, DwGeom g,
                    int vec, int pairs) {
  dw_dgrad_body<float, K>(gr, wd, da, g, vec, pairs);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
dw_wgrad_bf16_kernel(const bf16* a, const bf16* gr, bf16* dwd, float* part,
                     DwGeom g, int splits, int vec) {
  dw_wgrad_body<bf16, K>(a, gr, dwd, part, g, splits, vec);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
dw_wgrad_f32_kernel(const float* a, const float* gr, float* dwd, float* part,
                    DwGeom g, int splits, int vec) {
  dw_wgrad_body<float, K>(a, gr, dwd, part, g, splits, vec);
}

// dw[i] = round(part[0][i] + part[1][i] + ... + part[splits-1][i]), in
// that order
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
dw_wgrad_sum_kernel(const float* __restrict__ part, T* __restrict__ dwd,
                    int n, int splits) {
  for (int i = blockIdx.x * kSumThreads + threadIdx.x; i < n;
       i += gridDim.x * kSumThreads) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[size_t(k) * n + i];
    dwd[i] = Elem<T>::from_f(s);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned sum_blocks(long long n) {
  long long blocks = (n + kSumThreads - 1) / kSumThreads;
  return unsigned(blocks < 132 * 16 ? blocks : 132 * 16);
}

// Output geometry for the planned tile (th, tw). Returns false for a shape
// or tile the kernels do not take.
bool make_geom(Geom& g, int B, int T, int H, int W, int C, int E, int Co,
               int k, int s, int th, int tw) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || C < 1 || E < 1 || Co < 1 ||
      k < 1 || s < 1)
    return false;
  g.B = B; g.T = T; g.H = H; g.W = W; g.C = C; g.E = E; g.Co = Co;
  g.k = k; g.s = s; g.p = k / 2;
  g.To = (T + 2 * g.p - 1) / s + 1;
  g.Ho = (H + 2 * g.p - k) / s + 1;
  g.Wo = (W + 2 * g.p - k) / s + 1;
  if (g.Ho < 1 || g.Wo < 1 || th < 1 || tw < 1 || th > g.Ho || tw > g.Wo)
    return false;
  g.th = th; g.tw = tw;
  g.rows_in = (th - 1) * s + k;
  g.cols_in = (tw - 1) * s + k;
  g.n_tw = (g.Wo + tw - 1) / tw;
  g.n_tiles = ((g.Ho + th - 1) / th) * g.n_tw;
  // output frame t' reads input frame t'*s - p; those in [0, T) run
  g.to_first = (g.p + s - 1) / s;
  int last = (T - 1 + g.p) / s;
  if (last > g.To - 1) last = g.To - 1;
  g.n_valid = last >= g.to_first ? last - g.to_first + 1 : 0;
  return true;
}

typedef void (*PoolBf16)(const bf16*, const bf16*, const bf16*, float*,
                         float*, Geom, int, int, int);
typedef void (*MainBf16)(const bf16*, const bf16*, const bf16*, const bf16*,
                         const float*, bf16*, float*, Geom, int, int, int);

int launch_pool(const void* x, const void* w1, const void* wd, void* pooled,
                void* part, const Geom& g, int bf16_, int splits,
                cudaStream_t stream) {
  const long long n_chunks = (g.E + kEC - 1) / kEC;
  const long long items = (long long)g.n_valid * g.n_tiles;
  const long long blocks = g.B * n_chunks * splits;
  if (splits < 1 || (splits > 1 && (part == nullptr || splits > items)) ||
      blocks > 2147483647LL)
    return int(cudaErrorInvalidValue);
  cudaError_t err;
  if (bf16_) {
    const LayoutB l = make_layout_bf16(g, false);
    if (l.total > kMaxSmem) return int(cudaErrorInvalidValue);
    PoolBf16 kern = g.k == 3 ? pool_bf16_kernel<3>
                  : g.k == 5 ? pool_bf16_kernel<5> : pool_bf16_kernel<0>;
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(l.total));
    if (err != cudaSuccess) return int(err);
    const int vec_x = g.C % 8 == 0 && aligned16(x);
    const int vec_w = g.E % 8 == 0 && aligned16(w1) && aligned16(wd);
    kern<<<(unsigned)blocks, kThreads, l.total, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
        static_cast<const bf16*>(wd), static_cast<float*>(pooled),
        static_cast<float*>(part), g, splits, vec_x, vec_w);
  } else {
    const Layout l = make_layout(g, false);
    if (l.total > kMaxSmem) return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(pool_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(l.total));
    if (err != cudaSuccess) return int(err);
    pool_f32_kernel<<<(unsigned)blocks, kThreads, l.total, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(wd), static_cast<float*>(pooled),
        static_cast<float*>(part), g, splits);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  pool_split_sum_kernel<<<sum_blocks((long long)g.B * g.E), kSumThreads, 0,
                          stream>>>(static_cast<const float*>(part),
                                    static_cast<float*>(pooled), g.B, g.E,
                                    splits);
  return int(cudaGetLastError());
}

int launch_main(const void* x, const void* w1, const void* wd,
                const void* w2, const float* scale, void* out, void* part,
                const Geom& g, int bf16_, int splits, cudaStream_t stream) {
  const long long n_chunks = (g.E + kEC - 1) / kEC;
  const long long blocks = (long long)g.B * g.To * g.n_tiles * splits;
  if (splits < 1 || splits > n_chunks ||
      (splits > 1 && (part == nullptr || !bf16_)) || blocks > 2147483647LL)
    return int(cudaErrorInvalidValue);
  cudaError_t err;
  if (bf16_) {
    const LayoutB l = make_layout_bf16(g, true);
    if (l.total > kMaxSmem || (l.pp / 16) * (l.co16 / 8) > kWarps * kMaxTiles)
      return int(cudaErrorInvalidValue);
    MainBf16 kern = g.k == 3 ? main_bf16_kernel<3>
                  : g.k == 5 ? main_bf16_kernel<5> : main_bf16_kernel<0>;
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(l.total));
    if (err != cudaSuccess) return int(err);
    const int vec_x = g.C % 8 == 0 && aligned16(x);
    const int vec_w = g.E % 8 == 0 && g.Co % 8 == 0 && aligned16(w1) &&
                      aligned16(wd) && aligned16(w2);
    kern<<<(unsigned)blocks, kThreads, l.total, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
        static_cast<const bf16*>(wd), static_cast<const bf16*>(w2), scale,
        static_cast<bf16*>(out), static_cast<float*>(part), g, splits, vec_x,
        vec_w);
  } else {
    const Layout l = make_layout(g, true);
    if (l.total > kMaxSmem || g.th * g.tw * g.Co > kMaxOutTile)
      return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(main_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(l.total));
    if (err != cudaSuccess) return int(err);
    main_f32_kernel<<<(unsigned)blocks, kThreads, l.total, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(wd), static_cast<const float*>(w2), scale,
        static_cast<float*>(out), g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  const long long n = (long long)g.B * g.To * g.Ho * g.Wo * g.Co;
  main_split_sum_kernel<<<sum_blocks(n), kSumThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<bf16*>(out), n, splits);
  return int(cudaGetLastError());
}

// The dw kernels' geometry for the planned tile (th, tw) and chunk ec.
// Returns false for a shape or plan they do not take.
bool make_dw_geom(DwGeom& g, int B, int T, int H, int W, int E, int k,
                  int s, int th, int tw, int ec, int kind) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || E < 1 || k < 1 || s < 1 ||
      ec < 16 || ec > kMaxDwChunk || ec % 16 != 0)
    return false;
  g.B = B; g.T = T; g.H = H; g.W = W; g.E = E;
  g.k = k; g.s = s; g.p = k / 2;
  g.To = (T + 2 * g.p - 1) / s + 1;
  g.Ho = (H + 2 * g.p - k) / s + 1;
  g.Wo = (W + 2 * g.p - k) / s + 1;
  if (g.Ho < 1 || g.Wo < 1) return false;
  const int fh = kind == kDgrad ? H : g.Ho, fw = kind == kDgrad ? W : g.Wo;
  if (th < 1 || tw < 1 || th > fh || tw > fw) return false;
  g.th = th; g.tw = tw;
  g.ec = ec;
  g.n_chunks = (E + ec - 1) / ec;
  g.tpp = ec / 2;
  g.groups = kThreads / g.tpp;
  g.rows = dw_span(th, k, s, kind);
  g.cols = dw_span(tw, k, s, kind);
  g.n_tw = (fw + tw - 1) / tw;
  g.n_tiles = ((fh + th - 1) / th) * g.n_tw;
  g.to_first = (g.p + s - 1) / s;
  int last = (T - 1 + g.p) / s;
  if (last > g.To - 1) last = g.To - 1;
  g.n_valid = last >= g.to_first ? last - g.to_first + 1 : 0;
  return true;
}

template <typename T>
using DwPass = void (*)(const T*, const T*, T*, DwGeom, int, int);
template <typename T>
using DwWgrad = void (*)(const T*, const T*, T*, float*, DwGeom, int, int);

// the kernel of a pass for k (3 and 5 unrolled, any other k generic)
DwPass<bf16> dw_pass_kernel(const bf16*, int kind, int k) {
  if (kind == kStencil)
    return k == 3 ? dw_stencil_bf16_kernel<3>
         : k == 5 ? dw_stencil_bf16_kernel<5> : dw_stencil_bf16_kernel<0>;
  return k == 3 ? dw_dgrad_bf16_kernel<3>
       : k == 5 ? dw_dgrad_bf16_kernel<5> : dw_dgrad_bf16_kernel<0>;
}

DwPass<float> dw_pass_kernel(const float*, int kind, int k) {
  if (kind == kStencil)
    return k == 3 ? dw_stencil_f32_kernel<3>
         : k == 5 ? dw_stencil_f32_kernel<5> : dw_stencil_f32_kernel<0>;
  return k == 3 ? dw_dgrad_f32_kernel<3>
       : k == 5 ? dw_dgrad_f32_kernel<5> : dw_dgrad_f32_kernel<0>;
}

DwWgrad<bf16> dw_wgrad_kernel(const bf16*, int k) {
  return k == 3 ? dw_wgrad_bf16_kernel<3>
       : k == 5 ? dw_wgrad_bf16_kernel<5> : dw_wgrad_bf16_kernel<0>;
}

DwWgrad<float> dw_wgrad_kernel(const float*, int k) {
  return k == 3 ? dw_wgrad_f32_kernel<3>
       : k == 5 ? dw_wgrad_f32_kernel<5> : dw_wgrad_f32_kernel<0>;
}

bool aligned_to(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// The stencil (in = a, out = d) or dgrad (in = g, out = da) pass.
template <typename T>
int launch_dw_pass(int kind, const void* in, const void* wd, void* out,
                   const DwGeom& g, cudaStream_t stream) {
  const DwLayout l = make_dw_layout(g, kind, sizeof(T));
  const long long frames = (long long)g.B * (kind == kDgrad ? g.T : g.To);
  const long long blocks = frames * g.n_tiles * g.n_chunks;
  if (l.total > kMaxSmem || blocks > 2147483647LL)
    return int(cudaErrorInvalidValue);
  const DwPass<T> kern = dw_pass_kernel(static_cast<const T*>(nullptr), kind,
                                        g.k);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(l.total));
  if (err != cudaSuccess) return int(err);
  const int vec = (g.E * sizeof(T)) % 16 == 0 && aligned16(in);
  const int pairs = g.E % 2 == 0 && aligned_to(out, 2 * sizeof(T));
  kern<<<(unsigned)blocks, kThreads, l.total, stream>>>(
      static_cast<const T*>(in), static_cast<const T*>(wd),
      static_cast<T*>(out), g, vec, pairs);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dw_wgrad(const void* a, const void* gr, void* dwd, void* part,
                    const DwGeom& g, int splits, cudaStream_t stream) {
  const DwLayout l = make_dw_layout(g, kWgrad, sizeof(T));
  const long long items = (long long)g.B * g.n_valid * g.n_tiles;
  const long long blocks = (long long)g.n_chunks * splits;
  if (l.total > kMaxSmem || splits < 1 || splits > (items > 1 ? items : 1) ||
      (splits > 1 && part == nullptr) || blocks > 2147483647LL)
    return int(cudaErrorInvalidValue);
  const DwWgrad<T> kern = dw_wgrad_kernel(static_cast<const T*>(nullptr),
                                          g.k);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(l.total));
  if (err != cudaSuccess) return int(err);
  const int vec = (g.E * sizeof(T)) % 16 == 0 && aligned16(a) &&
                  aligned16(gr);
  kern<<<(unsigned)blocks, kThreads, l.total, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(gr),
      static_cast<T*>(dwd), static_cast<float*>(part), g, splits, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  const int n = g.k * g.k * g.E;
  dw_wgrad_sum_kernel<T><<<sum_blocks(n), kSumThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(dwd), n, splits);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// th, tw: the output tile of the wrapper's plan; splits: the number of
// ordered ranges the work is cut into (pool: each sample's items; main,
// bf16 only: the E-chunks), with workspace holding B*splits*E (pool) or
// splits*B*T'*H'*W'*Co (main) floats when splits > 1 (else it may be
// null). Returns 0, or the CUDA error of the launch (cudaErrorInvalidValue
// for a shape or plan the kernels do not take).
extern "C" int fb_pool(const void* x, const void* w1, const void* wd,
                       void* pooled, int dtype, int B, int T, int H, int W,
                       int C, int E, int k, int s, int th, int tw, int splits,
                       void* workspace, void* stream) {
  Geom g;
  if ((dtype != 0 && dtype != 1) ||
      !make_geom(g, B, T, H, W, C, E, 1, k, s, th, tw))
    return int(cudaErrorInvalidValue);
  return launch_pool(x, w1, wd, pooled, workspace, g, dtype, splits,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int fb_main(const void* x, const void* w1, const void* wd,
                       const void* w2, const void* scale, void* out,
                       int dtype, int B, int T, int H, int W, int C, int E,
                       int Co, int k, int s, int th, int tw, int splits,
                       void* workspace, void* stream) {
  Geom g;
  if ((dtype != 0 && dtype != 1) ||
      !make_geom(g, B, T, H, W, C, E, Co, k, s, th, tw))
    return int(cudaErrorInvalidValue);
  return launch_main(x, w1, wd, w2, static_cast<const float*>(scale), out,
                     workspace, g, dtype, splits,
                     static_cast<cudaStream_t>(stream));
}

// The depthwise stencil's backward. a, da (B,T,H,W,E); d, g (B,T',H',W',E);
// wd, dw (k*k,E); B, T, H, W are the input's in all three. th, tw: the
// plan's tile (output pixels for stencil and wgrad, input pixels for
// dgrad); ec: its channel chunk (a multiple of 16, at most 64); splits
// (wgrad): ordered ranges of the (sample, valid frame, tile) items, with
// workspace holding splits*k*k*E floats when splits > 1.
extern "C" int fb_dw_stencil(const void* a, const void* wd, void* out,
                             int dtype, int B, int T, int H, int W, int E,
                             int k, int s, int th, int tw, int ec,
                             void* stream) {
  DwGeom g;
  if ((dtype != 0 && dtype != 1) ||
      !make_dw_geom(g, B, T, H, W, E, k, s, th, tw, ec, kStencil))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype ? launch_dw_pass<bf16>(kStencil, a, wd, out, g, st)
               : launch_dw_pass<float>(kStencil, a, wd, out, g, st);
}

extern "C" int fb_dw_dgrad(const void* gr, const void* wd, void* da,
                           int dtype, int B, int T, int H, int W, int E,
                           int k, int s, int th, int tw, int ec,
                           void* stream) {
  DwGeom g;
  if ((dtype != 0 && dtype != 1) ||
      !make_dw_geom(g, B, T, H, W, E, k, s, th, tw, ec, kDgrad))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype ? launch_dw_pass<bf16>(kDgrad, gr, wd, da, g, st)
               : launch_dw_pass<float>(kDgrad, gr, wd, da, g, st);
}

extern "C" int fb_dw_wgrad(const void* a, const void* gr, void* dwd,
                           int dtype, int B, int T, int H, int W, int E,
                           int k, int s, int th, int tw, int ec, int splits,
                           void* workspace, void* stream) {
  DwGeom g;
  if ((dtype != 0 && dtype != 1) ||
      !make_dw_geom(g, B, T, H, W, E, k, s, th, tw, ec, kWgrad))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype ? launch_dw_wgrad<bf16>(a, gr, dwd, workspace, g, splits, st)
               : launch_dw_wgrad<float>(a, gr, dwd, workspace, g, splits,
                                        st);
}
