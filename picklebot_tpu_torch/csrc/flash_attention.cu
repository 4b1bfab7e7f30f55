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
// Layouts: element (s, h, n, d) of q, k, v, o lies at
// s*stride_s + h*stride_h + n*stride_n + d (stride 1 along d); lse (s, h, n)
// at s*lse_s + h*lse_h + n. q, k, v and o share one dtype: float (dtype 0)
// or bf16 (dtype 1). D is 16, 32 or 64.
//
// The forward (FlashAttention-2's, as the Pallas kernels compute it): f32
// scores times scale, an online softmax with the running max m and sum l
// per query row in f32, P rounded to V's dtype before the PV product
// (unnormalised), l summed from the unrounded f32 P, f32 accumulation, the
// output acc / l cast once, and with lse requested lse = m + ln(l) in
// natural-log units (the backward kernels read it so). Keys past N count
// as the Pallas kernels' masked scores (p = 0).
//
// What bounds the forward on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the
// function must read Q, K, V and write O once, 4*S*H*N*D elements, and
// does 4*S*H*N^2*D useful FLOPs (QK^T and PV). At MobileViT-s's stage 1
// (S=64 sequences, H=8, N=784, D=16, bf16) that is 51 MB (15.3 us) against
// 2.0e10 FLOPs (20.3 us). But it also takes one exponential per score,
// 64*8*784^2 = 3.15e8, and the SFU does 16 per clock per SM (3.9e12/s over
// 132 SMs at 1.83 GHz): 81 us. At D=16 the exponentials bound it, not the
// products or the bytes.
//
// bf16 (fwd_bf16_kernel): 128 threads, 4 warps of 16 query rows, one block
// per (sequence, head, 64-query tile). Each warp keeps its Q rows as mma A
// fragments in registers for the whole loop. K and V stream through
// shared memory in 64-row bf16 tiles (padded rows, two cp.async stages, as
// the backward's). At D = 16 and 32 a tile is taken in two passes of 32
// keys, which halves the score accumulators: 71 and 95 registers, where one
// 64-key pass took 80 at D=16 with spills and 127 at D=32; at D = 64 in one
// pass of 64 keys (161 registers), as two passes made ptxas stop at 128
// and spill. Per pass: S = Q K^T on mma.sync m16n8k16 (K
// rows are the column-major B operand: plain ldmatrix), scaled by
// scale*log2(e); the row max over the four lanes that share a row (two
// __shfl_xor_sync), the accumulators and this lane's part of l rescaled by
// alpha = 2^(m_old - m_new); P = ex2.approx(s - m), one SFU op per score,
// added to l in f32, then rounded to bf16 in registers as the A fragment
// of O += P V (V read with ldmatrix.trans; P never touches shared
// memory). The four lanes' parts of l are summed once, at the end.
// The running max starts at kNegInf (-1e30), not -inf, so the first
// pass's alpha is 2^(-1e30 - m) = 0 and (-inf) - (-inf) never appears.
// Ragged N: cp.async zero-fills K and V rows past N, and a zero K row
// would give a score of 0, not a masked one, so in the last tile a key
// past N gets s = kNegInf before the max (p = 0), and a pass whose keys
// all lie past N is skipped; a query row past N is
// computed on zero Q but neither stored nor given an lse, and a warp whose
// rows all lie past N only helps with the copies. Without lse (the
// inference path, as _fwd_kernel_nolse) nothing else is stored. Loads and
// stores are 16 and 4 bytes wide, so bf16 views whose row starts are not
// 16-byte aligned are refused (cudaErrorInvalidValue; the wrapper refuses
// them first).
//   What still holds it back: at stage 1 it takes about 2.3x the SFU's
// time for its exponentials. Neither the ex2 pipe alone nor the issue
// rate explains that: rounding P on the integer pipe (freeing the
// conversion pipe) made it 25% slower, and 32 fewer instructions a pass
// (no accumulator clears, the scale folded into the exponent's FFMA) 4%
// slower. Left is the chain inside each warp, S -> max -> two shuffles ->
// ex2 -> pack -> PV, with 7 blocks (28 warps) an SM at D=16: the next
// pass's S is not issued before this pass's softmax (software pipelining
// across passes, more rows per warp, wgmma with TMA are later work). At
// N = 147 and 32 the grid is too short to fill the card and the Python
// wrapper's host work outlasts the kernel.
//
// f32 (fwd_f32_kernel) stays on the FP32 pipe: TF32 tensor cores would
// fail the f32 checks (2e-4 of max|ref|, lse within 1e-3). One block of
// kBQ = 64 threads per (sequence, head, 64-query tile), one thread per
// query row, which keeps its row, D f32 accumulators and the running max
// and sum in registers; K/V tiles of kBK = 64 rows staged in shared memory
// as f32 (a broadcast read), the scores of a tile in a shared (kBK, kBQ)
// tile, FMA loops, expf. A ragged N is loop bounds (the last tile's key
// loops stop at N, rows past N store nothing).
//
// The backward (FlashAttention-2's algorithm, as the Pallas pair runs it):
// with P = exp(scale * Q K^T - lse), dP = dO V^T, D = rowsum(dO * O) (f32,
// computed by the caller) and dS = P * (dP - D),
//   dq kernel:  dQ = scale * dS K               one block per (sequence,
//                                               head, 64-query tile)
//   dkv kernel: dV = P^T dO, dK = scale * dS^T Q   one block per (sequence,
//                                               head, 64-key tile)
// Each kernel recomputes S and dP (the dq kernel writes neither P nor dS
// out), so no (N, N) tensor reaches device memory, and every output element
// is written by one thread: no atomics, and the result does not depend on
// the schedule (that is why dQ and dK/dV stay two kernels). Numerics follow
// the Pallas kernels: f32 scores and statistics, P rounded to dO's dtype
// before the dV product and dS to the inputs' dtype before the dQ and dK
// products, f32 accumulation, the scale applied at the end, each output
// cast once.
//
// What bounds the pair on an H100: the function needs 10*N^2*D FLOPs per
// (sequence, head) (S, dP, dV, dQ and dK once; the pair does 14, since each
// kernel forms S and dP) and reads q, k, v, dO, lse and D and writes dq, dk,
// dv once. At MobileViT-s's stage 1 (64 sequences x 8 heads, N=784, D=16,
// bf16) that is 5.0e10 FLOPs (51 us at 989 TFLOP/s) against 93 MB (28 us).
// But at D=16 a score costs only 16 MACs per product, and each kernel takes
// one exponential per score: 64*8*784^2 = 3.2e8 exps per kernel, and the
// SFU does 16 per clock per SM (3.9e12/s over 132 SMs at the 1.83 GHz
// behind the 989 TFLOP/s figure), 81 us per kernel. With about four
// FP32-pipe ops per score beside it (scale and subtract lse, dP - D, times
// P, the bf16 packs), the exponentials and the elementwise work on the N^2
// scores bound the pair, not the MMAs.
//
// bf16 (dq_bf16_kernel, dkv_bf16_kernel): 128 threads, 4 warps of 16 rows,
// the products on mma.sync m16n8k16 (bf16 in, f32 accumulate), so the
// tensor cores take the MACs and the FP32 pipe and SFU are left with the
// per-score work.
//   dq: each warp keeps its 16 query rows of Q and dO as A fragments in
//     registers for the whole loop. Per 64-key tile it computes S = Q K^T
//     and dP = dO V^T (K and V rows are the column-major B operand: plain
//     ldmatrix), forms P and dS in the accumulator registers, repacks dS to
//     bf16 in registers as the A operand of dQ += dS K (two adjacent n8
//     accumulator tiles are one k16 A tile; no trip through shared memory)
//     and reads K again with ldmatrix.trans.
//   dkv: each warp keeps its 16 key rows of K and V as A fragments and
//     computes the transposed scores S^T = K Q^T and dP^T = V dO^T, so P^T
//     and dS^T come out as A fragments for dV += P^T dO and dK += dS^T Q (dO
//     and Q read with ldmatrix.trans). lse and D then index the column:
//     each query tile's 64 values sit in shared memory beside it.
//   Both: the streamed tiles (K and V, or Q and dO) are bf16 in shared
//     memory, filled by 16-byte cp.async in two stages (the next tile lands
//     while this one is used); each row is padded by 16 bytes, so the 8
//     rows of an ldmatrix fall in 8 different bank groups (an unpadded D=16
//     row is 32 bytes, a two-way conflict). exp is ex2.approx of the
//     log2(e)-scaled score minus the log2(e)-scaled lse: one SFU op, about
//     2^-22 relative error, far inside the bf16 bounds. Past N: a key gets
//     p = 0 explicitly in dq (a zero K row alone would give p = exp(-lse));
//     a query gets lse = +inf and D = 0 in dkv, so its p is exactly 0 with
//     no instruction per score; rows past N are zero-filled (cp.async with
//     src-size 0) and never stored; a warp whose rows all lie past N only
//     helps with the copies. A tile is taken in two passes of 32 columns,
//     which halves the score accumulators (dq at D=16: 80 registers, not
//     118, so more blocks share an SM) and keeps dkv at D=64 from
//     spilling. Loads and stores are 16 and 4 bytes wide, so the wrapper
//     refuses views whose row starts are not 16-byte aligned (bwd returns
//     cudaErrorInvalidValue for them too).
//   What still holds it back: the exponentials, taken twice (once in each
//     kernel, the price of no atomics); mma.sync's issue rate and the
//     ldmatrix traffic of four warps reading the same tile (wgmma with TMA,
//     and more rows per warp, are later work); at N = 147 and 32 a grid too
//     short to fill the card, and the Python wrapper's host work per call.
//
// f32 (dq_f32_kernel, dkv_f32_kernel) stays on the FP32 pipe: TF32 tensor
// cores would fail the f32 checks. One thread per query (or key) row keeps
// its row and its f32 accumulators in registers and streams the other
// side's 64-row tiles through shared memory as f32, one streamed row at a
// time as scalars. A ragged N is loop bounds only, which equals the Pallas
// kernels' zero padding (zero K rows add nothing to dQ; padded query rows
// carry dO = 0 and add nothing to dK or dV).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows (threads) per f32 block
constexpr int kBK = 64;                 // key/value rows per f32 shared tile
constexpr float kNegInf = -1e30f;       // as the Pallas kernels' _NEG_INF

struct Strides {
  long long s, h, n;
};

// ---------------------------------------------------------------------------
// bf16 building blocks: mma.sync tensor cores, cp.async, ex2
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kMmaThreads = 128;        // 4 warps of 16 rows
constexpr int kTile = 64;               // rows per block and per streamed tile
static_assert(kTile == kMmaThreads / 32 * 16, "16 rows per warp");
static_assert(kTile == kBQ && kTile == kBK, "one 64-row tiling");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (ex2.approx.ftz: one instruction; 2^-inf is +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to bf16 in one register, lo in the low half (the
// lower column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The warp's rows [r0, r0 + 16) of an (N, D) operand as mma A fragments,
// one per 16 columns, read straight from device memory (once per block):
// lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, columns 2t,
// 2t + 1 and 2t + 8, 2t + 9. Rows past N are zero.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                       const bf16* base, long long stride,
                                       int r0, int n, int lane) {
  const int ra = r0 + (lane >> 2), rb = ra + 8, c = 2 * (lane & 3);
  const unsigned* pa =
      reinterpret_cast<const unsigned*>(base + ra * stride + c);
  const unsigned* pb =
      reinterpret_cast<const unsigned*>(base + rb * stride + c);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = ra < n ? __ldg(pa + 8 * kk) : 0u;
    f[kk][1] = rb < n ? __ldg(pb + 8 * kk) : 0u;
    f[kk][2] = ra < n ? __ldg(pa + 8 * kk + 4) : 0u;
    f[kk][3] = rb < n ? __ldg(pb + 8 * kk + 4) : 0u;
  }
}

// Rows [r0, r0 + 64) of an (N, D) operand into a padded shared tile by
// 16-byte cp.async (every thread of the block takes its share); rows past N
// are zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile(bf16 (*dst)[D + 8],
                                          const bf16* src, long long stride,
                                          int r0, int n) {
  constexpr int kChunks = D / 8;        // 16-byte chunks per row
  static_assert(kTile * kChunks % kMmaThreads == 0, "whole rounds");
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kMmaThreads; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r0 + r < n;
    cp_async16(smem_addr(&dst[r][col]),
               ok ? src + (r0 + r) * stride + col : src, ok);
  }
}

// The accumulators of 16 columns (two n8 tiles j and j + 1) rounded to bf16
// as the A fragment of a k16 step: rows g and g + 8, columns 2t, 2t + 1 of
// each tile.
__device__ __forceinline__ void pack_a(uint32_t (&f)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  f[0] = pack_bf16(lo[0], lo[1]);
  f[1] = pack_bf16(lo[2], lo[3]);
  f[2] = pack_bf16(hi[0], hi[1]);
  f[3] = pack_bf16(hi[2], hi[3]);
}

// Stores rows g and g + 8 (of the warp's rows from r0) of a (16, D)
// accumulator, times mul, as bf16 pairs; rows past N are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long stride,
                                           const float (&acc)[D / 8][4],
                                           float mul, int r0, int n,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + (lane >> 2) + 8 * i;
    if (row >= n) continue;
    bf16* out = base + row * stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                           // null: no lse output
  Strides qs, ks, vs, os;
  long long lse_s, lse_h;
  int S, H, N, n_t;                     // n_t: 64-row tiles of N
  float scale;
};

// f32: one block per (sequence, head, 64-query tile), one thread per query
// row, FMA loops.
template <int D>
__global__ void __launch_bounds__(kBQ) fwd_f32_kernel(Args a) {
  __shared__ __align__(16) float k_tile[kBK][D];
  __shared__ __align__(16) float v_tile[kBK][D];
  __shared__ float s_tile[kBK][kBQ];

  const int qt = blockIdx.x % a.n_t;
  const int sh = blockIdx.x / a.n_t;
  const int h = sh % a.H, s = sh / a.H;
  const int row = qt * kBQ + threadIdx.x;
  const bool active = row < a.N;

  const float* q = static_cast<const float*>(a.q) + s * a.qs.s + h * a.qs.h;
  const float* k = static_cast<const float*>(a.k) + s * a.ks.s + h * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + s * a.vs.s + h * a.vs.h;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? q[row * a.qs.n + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < a.N; k0 += kBK) {
    const int nk = min(kBK, a.N - k0);
    __syncthreads();                    // previous tile done with smem
    for (int idx = threadIdx.x; idx < nk * D; idx += kBQ) {
      const int r = idx / D, d = idx % D;
      k_tile[r][d] = k[(k0 + r) * a.ks.n + d];
      v_tile[r][d] = v[(k0 + r) * a.vs.n + d];
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
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_tile[j][d], acc[d]);
    }
    l = l * alpha + l_tile;
    m = m_new;
  }

  if (!active) return;
  float* o =
      static_cast<float*>(a.o) + s * a.os.s + h * a.os.h + row * a.os.n;
  const float inv_l = 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = acc[d] * inv_l;
  if (a.lse != nullptr)
    a.lse[s * a.lse_s + h * a.lse_h + row] = m + logf(l);
}

// bf16: one block per (sequence, head, 64-query tile); warp w owns queries
// [16w, 16w + 16) of it: O_i = sum_j round(p_ij) v_j / l_i, with the running
// max m_i (in log2 units) and sum l_i of the online softmax.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) fwd_bf16_kernel(Args a) {
  constexpr int kP = D + 8;               // bf16 per shared row (16 B pad)
  constexpr int kSub = D == 64 ? 64 : 32;  // keys per pass over a tile
  constexpr int NT = kSub / 8;            // n8 score tiles per pass
  __shared__ __align__(16) bf16 k_s[2][kTile][kP];
  __shared__ __align__(16) bf16 v_s[2][kTile][kP];

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int qt = blockIdx.x % a.n_t;
  const int sh = blockIdx.x / a.n_t;
  const int h = sh % a.H, s = sh / a.H;
  const int r0 = qt * kTile + (threadIdx.x >> 5) * 16;
  const bool busy = r0 < a.N;             // else the warp only copies

  const bf16* q = static_cast<const bf16*>(a.q) + s * a.qs.s + h * a.qs.h;
  const bf16* k = static_cast<const bf16*>(a.k) + s * a.ks.s + h * a.ks.h;
  const bf16* v = static_cast<const bf16*>(a.v) + s * a.vs.s + h * a.vs.h;

  uint32_t qf[D / 16][4];
  load_a<D>(qf, q, a.qs.n, r0, a.N, lane);
  const float scale2 = a.scale * kLog2e;
  // rows g and g + 8: the running max (shared by the row's four lanes) and
  // this lane's part of the running sum (its 16 of each tile's 64 keys)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  copy_tile<D>(k_s[0], k, a.ks.n, 0, a.N);
  copy_tile<D>(v_s[0], v, a.vs.n, 0, a.N);
  cp_async_commit();
  for (int it = 0; it < a.n_t; ++it) {
    cp_async_wait<0>();                   // this tile has landed ...
    __syncthreads();                      // ... for every thread, and the
                                          // other stage is no longer read
    if (it + 1 < a.n_t) {
      copy_tile<D>(k_s[(it + 1) & 1], k, a.ks.n, (it + 1) * kTile, a.N);
      copy_tile<D>(v_s[(it + 1) & 1], v, a.vs.n, (it + 1) * kTile, a.N);
    }
    cp_async_commit();
    if (!busy) continue;
    const uint32_t kb = smem_addr(&k_s[it & 1][0][0]);
    const uint32_t vb = smem_addr(&v_s[it & 1][0][0]);
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kSub) {
      const int keys_left = a.N - (it * kTile + c0);
      if (keys_left <= 0) break;          // the rest of the tile is past N
      // S = Q K^T: key rows of the tile are the B operand
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          const int row = c0 + 16 * p + (lane & 7) + ((lane >> 4) << 3);
          uint32_t b[4];
          ldmatrix_x4(b, kb + (row * kP + 16 * kk + ((lane >> 3) & 1) * 8) * 2);
          mma_bf16(sc[2 * p], qf[kk], b[0], b[1]);
          mma_bf16(sc[2 * p + 1], qf[kk], b[2], b[3]);
        }
      }
      // scores in log2 units; a key past N is masked before the max
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[j][r] *= scale2;
      if (keys_left < kSub) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (8 * j + 2 * t + (r & 1) >= keys_left) sc[j][r] = kNegInf;
      }
      // the rows' new max over the quad; alpha rescales once per pass
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) mx[r >> 1] = fmaxf(mx[r >> 1], sc[j][r]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float alpha = ex2(m[i] - mx[i]);
        l[i] *= alpha;
        m[i] = mx[i];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[j][2 * i] *= alpha;
          acc[j][2 * i + 1] *= alpha;
        }
      }
      // P in f32 into l, in place of S
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = ex2(sc[j][r] - m[r >> 1]);
          l[r >> 1] += p;
          sc[j][r] = p;
        }
      // O += round(P) V: P repacked in registers, V read transposed
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t af[4];
        pack_a(af, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vb + ((c0 + 16 * kk + (lane & 15)) * kP +
                                     16 * p + (lane >> 4) * 8) * 2);
          mma_bf16(acc[2 * p], af, b[0], b[1]);
          mma_bf16(acc[2 * p + 1], af, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!busy) return;
  // the row sums over the quad, then O = acc / l and lse = m + ln(l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv_l = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][2 * i] *= inv_l;
      acc[j][2 * i + 1] *= inv_l;
    }
  }
  store_rows<D>(static_cast<bf16*>(a.o) + s * a.os.s + h * a.os.h, a.os.n,
                acc, 1.f, r0, a.N, lane);
  if (a.lse == nullptr || t != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + (lane >> 2) + 8 * i;
    if (row < a.N)
      a.lse[s * a.lse_s + h * a.lse_h + row] = (m[i] + log2f(l[i])) * kLn2;
  }
}

template <int D>
int launch_fwd(const Args& a, bool bf16_, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(a.n_t) * a.H * a.S;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (bf16_) fwd_bf16_kernel<D><<<grid, kMmaThreads, 0, stream>>>(a);
  else fwd_f32_kernel<D><<<grid, kBQ, 0, stream>>>(a);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// f32 backward: one thread per row, FMA loops
// ---------------------------------------------------------------------------

// One block per (sequence, head, 64-query tile), one thread per query row:
// dQ_i = scale * sum_j P_ij (dP_ij - D_i) k_j over every key j.
template <int D>
__global__ void __launch_bounds__(kBQ) dq_f32_kernel(BwdArgs a) {
  __shared__ __align__(16) float k_tile[kBK][D];
  __shared__ __align__(16) float v_tile[kBK][D];

  const int qt = blockIdx.x % a.n_t;
  const int sh = blockIdx.x / a.n_t;
  const int h = sh % a.H, s = sh / a.H;
  const int row = qt * kBQ + threadIdx.x;
  const bool active = row < a.N;

  const float* q = static_cast<const float*>(a.q) + s * a.qs.s + h * a.qs.h;
  const float* k = static_cast<const float*>(a.k) + s * a.ks.s + h * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + s * a.vs.s + h * a.vs.h;
  const float* dout =
      static_cast<const float*>(a.dout) + s * a.dos.s + h * a.dos.h;

  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? q[row * a.qs.n + d] : 0.f;
    dor[d] = active ? dout[row * a.dos.n + d] : 0.f;
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
      k_tile[j][d] = k[(k0 + j) * a.ks.n + d];
      v_tile[j][d] = v[(k0 + j) * a.vs.n + d];
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
      const float ds = expf(sc * a.scale - lse) * (dp - dd);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, k_tile[j][d], acc[d]);
    }
  }

  if (!active) return;
  float* dq = static_cast<float*>(a.dq) + s * a.dqs.s + h * a.dqs.h +
              row * a.dqs.n;
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = acc[d] * a.scale;
}

// One block per (sequence, head, 64-key tile), one thread per key row:
// dV_j = sum_i P_ij dO_i and dK_j = scale * sum_i dS_ij q_i over every
// query i, with the query tiles (q, dO, lse, D) in shared memory.
template <int D>
__global__ void __launch_bounds__(kBK) dkv_f32_kernel(BwdArgs a) {
  __shared__ __align__(16) float q_tile[kBQ][D];
  __shared__ __align__(16) float do_tile[kBQ][D];
  __shared__ float lse_tile[kBQ];
  __shared__ float dd_tile[kBQ];

  const int kt = blockIdx.x % a.n_t;
  const int sh = blockIdx.x / a.n_t;
  const int h = sh % a.H, s = sh / a.H;
  const int col = kt * kBK + threadIdx.x;
  const bool active = col < a.N;

  const float* q = static_cast<const float*>(a.q) + s * a.qs.s + h * a.qs.h;
  const float* k = static_cast<const float*>(a.k) + s * a.ks.s + h * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + s * a.vs.s + h * a.vs.h;
  const float* dout =
      static_cast<const float*>(a.dout) + s * a.dos.s + h * a.dos.h;
  const float* lse = a.lse + s * a.lse_s + h * a.lse_h;
  const float* dd = a.dd + s * a.lse_s + h * a.lse_h;

  float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = active ? k[col * a.ks.n + d] : 0.f;
    vr[d] = active ? v[col * a.vs.n + d] : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }

  for (int q0 = 0; q0 < a.N; q0 += kBQ) {
    const int nq = min(kBQ, a.N - q0);
    __syncthreads();                    // previous tile done with smem
    for (int idx = threadIdx.x; idx < nq * D; idx += kBK) {
      const int i = idx / D, d = idx % D;
      q_tile[i][d] = q[(q0 + i) * a.qs.n + d];
      do_tile[i][d] = dout[(q0 + i) * a.dos.n + d];
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
      const float ds = p * (dp - dd_tile[i]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(p, do_tile[i][d], dv[d]);
        dk[d] = fmaf(ds, q_tile[i][d], dk[d]);
      }
    }
  }

  if (!active) return;
  float* dkp = static_cast<float*>(a.dk) + s * a.dks.s + h * a.dks.h +
               col * a.dks.n;
  float* dvp = static_cast<float*>(a.dv) + s * a.dvs.s + h * a.dvs.h +
               col * a.dvs.n;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dkp[d] = dk[d] * a.scale;
    dvp[d] = dv[d];
  }
}

// One block per (sequence, head, 64-query tile); warp w owns queries
// [16w, 16w + 16) of it: dQ_i = scale * sum_j round(P_ij (dP_ij - D_i)) k_j.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) dq_bf16_kernel(BwdArgs a) {
  constexpr int kP = D + 8;               // bf16 per shared row (16 B pad)
  constexpr int kSub = 32;               // keys per pass over a tile
  constexpr int NT = kSub / 8;            // n8 score tiles per pass
  __shared__ __align__(16) bf16 k_s[2][kTile][kP];
  __shared__ __align__(16) bf16 v_s[2][kTile][kP];

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int qt = blockIdx.x % a.n_t;
  const int sh = blockIdx.x / a.n_t;
  const int h = sh % a.H, s = sh / a.H;
  const int r0 = qt * kTile + (threadIdx.x >> 5) * 16;
  const bool busy = r0 < a.N;             // else the warp only copies

  const bf16* q = static_cast<const bf16*>(a.q) + s * a.qs.s + h * a.qs.h;
  const bf16* k = static_cast<const bf16*>(a.k) + s * a.ks.s + h * a.ks.h;
  const bf16* v = static_cast<const bf16*>(a.v) + s * a.vs.s + h * a.vs.h;
  const bf16* dout =
      static_cast<const bf16*>(a.dout) + s * a.dos.s + h * a.dos.h;

  uint32_t qf[D / 16][4], of[D / 16][4];
  load_a<D>(qf, q, a.qs.n, r0, a.N, lane);
  load_a<D>(of, dout, a.dos.n, r0, a.N, lane);
  // rows g and g + 8: -lse * log2(e) and D (0 past N: such rows have q = 0
  // and dO = 0, so their dS is 0, and they are not stored)
  float nl[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + (lane >> 2) + 8 * i;
    const long long r = s * a.lse_s + h * a.lse_h + row;
    nl[i] = row < a.N ? -a.lse[r] * kLog2e : 0.f;
    dd[i] = row < a.N ? a.dd[r] : 0.f;
  }
  const float scale2 = a.scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  copy_tile<D>(k_s[0], k, a.ks.n, 0, a.N);
  copy_tile<D>(v_s[0], v, a.vs.n, 0, a.N);
  cp_async_commit();
  for (int it = 0; it < a.n_t; ++it) {
    cp_async_wait<0>();                   // this tile has landed ...
    __syncthreads();                      // ... for every thread, and the
                                          // other stage is no longer read
    if (it + 1 < a.n_t) {
      copy_tile<D>(k_s[(it + 1) & 1], k, a.ks.n, (it + 1) * kTile, a.N);
      copy_tile<D>(v_s[(it + 1) & 1], v, a.vs.n, (it + 1) * kTile, a.N);
    }
    cp_async_commit();
    if (!busy) continue;
    const uint32_t kb = smem_addr(&k_s[it & 1][0][0]);
    const uint32_t vb = smem_addr(&v_s[it & 1][0][0]);
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kSub) {
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[j][r] = dp[j][r] = 0.f;
      // S = Q K^T and dP = dO V^T: key rows of the tile are the B operand
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          const int row = c0 + 16 * p + (lane & 7) + ((lane >> 4) << 3);
          const uint32_t off =
              (row * kP + 16 * kk + ((lane >> 3) & 1) * 8) * 2;
          uint32_t b[4];
          ldmatrix_x4(b, kb + off);
          mma_bf16(sc[2 * p], qf[kk], b[0], b[1]);
          mma_bf16(sc[2 * p + 1], qf[kk], b[2], b[3]);
          ldmatrix_x4(b, vb + off);
          mma_bf16(dp[2 * p], of[kk], b[0], b[1]);
          mma_bf16(dp[2 * p + 1], of[kk], b[2], b[3]);
        }
      }
      // P, then dS = P (dP - D) in place of S; a key past N has p = 0
      const int keys_left = a.N - (it * kTile + c0);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sc[j][r] = ex2(fmaf(sc[j][r], scale2, nl[r >> 1]));
      if (keys_left < kSub) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (8 * j + 2 * t + (r & 1) >= keys_left) sc[j][r] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sc[j][r] *= dp[j][r] - dd[r >> 1];
      // dQ += round(dS) K: dS repacked in registers, K read transposed
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t af[4];
        pack_a(af, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, kb + ((c0 + 16 * kk + (lane & 15)) * kP +
                                     16 * p + (lane >> 4) * 8) * 2);
          mma_bf16(acc[2 * p], af, b[0], b[1]);
          mma_bf16(acc[2 * p + 1], af, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (busy)
    store_rows<D>(static_cast<bf16*>(a.dq) + s * a.dqs.s + h * a.dqs.h,
                  a.dqs.n, acc, a.scale, r0, a.N, lane);
}

// One block per (sequence, head, 64-key tile); warp w owns keys
// [16w, 16w + 16) of it and works on the transposed scores:
// dV_j = sum_i round(P_ij) dO_i, dK_j = scale * sum_i round(dS_ij) q_i.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) dkv_bf16_kernel(BwdArgs a) {
  constexpr int kP = D + 8;
  constexpr int kSub = 32;               // queries per pass over a tile
  constexpr int NT = kSub / 8;
  __shared__ __align__(16) bf16 q_s[2][kTile][kP];
  __shared__ __align__(16) bf16 o_s[2][kTile][kP];     // dO
  // per query of a tile: [0] -lse * log2(e) (-inf past N), [1] D (0 past N)
  __shared__ __align__(16) float st_s[2][2][kTile];

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int kt = blockIdx.x % a.n_t;
  const int sh = blockIdx.x / a.n_t;
  const int h = sh % a.H, s = sh / a.H;
  const int r0 = kt * kTile + (threadIdx.x >> 5) * 16;
  const bool busy = r0 < a.N;

  const bf16* q = static_cast<const bf16*>(a.q) + s * a.qs.s + h * a.qs.h;
  const bf16* k = static_cast<const bf16*>(a.k) + s * a.ks.s + h * a.ks.h;
  const bf16* v = static_cast<const bf16*>(a.v) + s * a.vs.s + h * a.vs.h;
  const bf16* dout =
      static_cast<const bf16*>(a.dout) + s * a.dos.s + h * a.dos.h;

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, k, a.ks.n, r0, a.N, lane);
  load_a<D>(vf, v, a.vs.n, r0, a.N, lane);
  const float scale2 = a.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[j][r] = dv[j][r] = 0.f;

  // statistics: threads 0-63 read the lse of query tid of a tile, 64-127
  // its D; a query past N gets lse = +inf (so p = 2^-inf = 0) and D = 0
  const int which = threadIdx.x / kTile, si = threadIdx.x % kTile;
  const float* stat = (which ? a.dd : a.lse) + s * a.lse_s + h * a.lse_h;
  auto read_stat = [&](int q0) -> float {
    const int qi = q0 + si;
    if (qi >= a.N) return which ? 0.f : -__int_as_float(0x7f800000);
    return which ? stat[qi] : -stat[qi] * kLog2e;
  };

  copy_tile<D>(q_s[0], q, a.qs.n, 0, a.N);
  copy_tile<D>(o_s[0], dout, a.dos.n, 0, a.N);
  cp_async_commit();
  st_s[0][which][si] = read_stat(0);
  for (int it = 0; it < a.n_t; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const bool more = it + 1 < a.n_t;
    float next = 0.f;                     // the next tile's statistic, held
    if (more) {                           // in a register while this one runs
      copy_tile<D>(q_s[(it + 1) & 1], q, a.qs.n, (it + 1) * kTile, a.N);
      copy_tile<D>(o_s[(it + 1) & 1], dout, a.dos.n, (it + 1) * kTile, a.N);
      next = read_stat((it + 1) * kTile);
    }
    cp_async_commit();
    if (busy) {
      const int buf = it & 1;
      const uint32_t qb = smem_addr(&q_s[buf][0][0]);
      const uint32_t ob = smem_addr(&o_s[buf][0][0]);
#pragma unroll
      for (int c0 = 0; c0 < kTile; c0 += kSub) {
        float sc[NT][4], dp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) sc[j][r] = dp[j][r] = 0.f;
        // S^T = K Q^T and dP^T = V dO^T: query rows are the B operand
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            const int row = c0 + 16 * p + (lane & 7) + ((lane >> 4) << 3);
            const uint32_t off =
                (row * kP + 16 * kk + ((lane >> 3) & 1) * 8) * 2;
            uint32_t b[4];
            ldmatrix_x4(b, qb + off);
            mma_bf16(sc[2 * p], kf[kk], b[0], b[1]);
            mma_bf16(sc[2 * p + 1], kf[kk], b[2], b[3]);
            ldmatrix_x4(b, ob + off);
            mma_bf16(dp[2 * p], vf[kk], b[0], b[1]);
            mma_bf16(dp[2 * p + 1], vf[kk], b[2], b[3]);
          }
        }
        // P^T in place of S^T, dS^T in place of dP^T; lse and D by column
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          const float2 nl = *reinterpret_cast<const float2*>(
              &st_s[buf][0][col]);
          const float2 dd = *reinterpret_cast<const float2*>(
              &st_s[buf][1][col]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = ex2(fmaf(sc[j][r], scale2, r & 1 ? nl.y : nl.x));
            sc[j][r] = p;
            dp[j][r] = p * (dp[j][r] - (r & 1 ? dd.y : dd.x));
          }
        }
        // dV += round(P^T) dO and dK += round(dS^T) Q: both repacked in
        // registers, dO and Q read transposed
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          uint32_t pf[4], sf[4];
          pack_a(pf, sc[2 * kk], sc[2 * kk + 1]);
          pack_a(sf, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
          for (int p = 0; p < D / 16; ++p) {
            const uint32_t off = ((c0 + 16 * kk + (lane & 15)) * kP +
                                  16 * p + (lane >> 4) * 8) * 2;
            uint32_t b[4];
            ldmatrix_x4_trans(b, ob + off);
            mma_bf16(dv[2 * p], pf, b[0], b[1]);
            mma_bf16(dv[2 * p + 1], pf, b[2], b[3]);
            ldmatrix_x4_trans(b, qb + off);
            mma_bf16(dk[2 * p], sf, b[0], b[1]);
            mma_bf16(dk[2 * p + 1], sf, b[2], b[3]);
          }
        }
      }
    }
    if (more) st_s[(it + 1) & 1][which][si] = next;
  }
  cp_async_wait<0>();
  if (!busy) return;
  store_rows<D>(static_cast<bf16*>(a.dk) + s * a.dks.s + h * a.dks.h,
                a.dks.n, dk, a.scale, r0, a.N, lane);
  store_rows<D>(static_cast<bf16*>(a.dv) + s * a.dvs.s + h * a.dvs.h,
                a.dvs.n, dv, 1.f, r0, a.N, lane);
}

// Every row start of a bf16 view on 16 bytes (the copies are 16 bytes, the
// fragment loads and stores 4): the base, and each stride of an axis longer
// than 1 a multiple of 8 elements.
bool rows_aligned16(const void* p, const Strides& st, int S, int H, int N) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (S == 1 || st.s % 8 == 0) && (H == 1 || st.h % 8 == 0) &&
         (N == 1 || st.n % 8 == 0);
}

template <int D>
int launch_bwd(const BwdArgs& a, bool dkv, bool bf16_, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(a.n_t) * a.H * a.S;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (bf16_ && dkv) dkv_bf16_kernel<D><<<grid, kMmaThreads, 0, stream>>>(a);
  else if (bf16_) dq_bf16_kernel<D><<<grid, kMmaThreads, 0, stream>>>(a);
  else if (dkv) dkv_f32_kernel<D><<<grid, kBK, 0, stream>>>(a);
  else dq_f32_kernel<D><<<grid, kBQ, 0, stream>>>(a);
  return int(cudaGetLastError());
}

int bwd(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* dd, void* dq,
        void* dk, void* dv, int dtype, int S, int H, int N, int D,
        float scale, const long long* strides, void* stream) {
  if (S < 1 || H < 1 || N < 1 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
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
  a.n_t = (N + kTile - 1) / kTile;
  a.scale = scale;
  const bool bf16_ = dtype == 1;
  if (bf16_) {
    const void* ptrs[] = {q, k, v, dout, dq, dk, dv};
    for (int i = 0; i < 7; ++i)
      if (!rows_aligned16(ptrs[i], *st[i], S, H, N))
        return int(cudaErrorInvalidValue);
  }
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_bwd<16>(a, dkv, bf16_, st_);
    case 32: return launch_bwd<32>(a, dkv, bf16_, st_);
    case 64: return launch_bwd<64>(a, dkv, bf16_, st_);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// strides: 14 int64 values, (s, h, n) for q, k, v and o, then (s, h) for
// lse (ignored when lse is null). Returns 0, or the CUDA error of the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int dtype, int S, int H, int N, int D,
                      float scale, const long long* strides, void* stream) {
  if (S < 1 || H < 1 || N < 1 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
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
  a.n_t = (N + kTile - 1) / kTile;
  a.scale = scale;
  const bool bf16_ = dtype == 1;
  if (bf16_) {
    const void* ptrs[] = {q, k, v, o};
    const Strides* st[] = {&a.qs, &a.ks, &a.vs, &a.os};
    for (int i = 0; i < 4; ++i)
      if (!rows_aligned16(ptrs[i], *st[i], S, H, N))
        return int(cudaErrorInvalidValue);
  }
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<16>(a, bf16_, st_);
    case 32: return launch_fwd<32>(a, bf16_, st_);
    case 64: return launch_fwd<64>(a, bf16_, st_);
    default: return int(cudaErrorInvalidValue);
  }
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
