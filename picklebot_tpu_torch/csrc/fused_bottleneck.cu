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
// Both grids are one-dimensional (grid.x takes up to 2^31 - 1 blocks, grid.y
// only 65,535), so no batch size the reference takes is refused.
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
