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
// ridge, so the bound is operations: the bf16 path has to be on the tensor
// cores.
//
// Design: an implicit GEMM. The TPU kernel staged whole frames into VMEM
// slabs with the edge masks baked in, merged (h, w) into one row axis and
// packed adjacent W taps to fill 128 lanes; none of that is carried over.
// Here the M axis is the flat output position (b,t,h,w), N is Co and K
// runs over the taps and Ci.
//
// bf16 (conv_bf16_kernel): 4 warps own a 128 x BN tile (BN = 64 or 96,
// chosen by the wrapper to waste the fewest columns of Co); each warp a
// 64 x BN/2 part of it, as 4 x BN/16 mma.sync m16n8k16 tiles with f32
// accumulators. K advances in steps of one tap and 32 input channels:
//   1. each thread copies, with 16-byte cp.async, 8 channels of 4 output
//      positions shifted by the tap (the zero-fill form where the tap
//      leaves the clip in T, H or W, or the row lies past M: the TPU
//      kernel's edge masks), and 8 channels of this tap's weight rows;
//   2. three stages in shared memory keep two steps' copies in flight
//      while the tensor cores work on the third; rows are padded by 16
//      bytes so ldmatrix (A) and ldmatrix.trans (B, stored (Ci, Co)) read
//      without bank conflicts;
//   3. where Ci or Co is no multiple of 8 or a base is not 16-byte
//      aligned, the same kernel loads with plain scalar loads instead.
// Where the grid has too few blocks to fill the card (MobileViT-s's
// stages 2 and 3 at bs 8), the wrapper splits the taps into contiguous
// ranges over grid.z: each split writes its f32 partial sums into a
// workspace (splits, M, Co) and conv_split_sum_kernel adds them in split
// order and rounds once. No atomics: the result does not depend on the
// schedule.
//
// f32 (conv_f32_kernel) stays on the FP32 pipe: TF32 tensor cores keep
// about three decimal digits and would fail the f32 checks (1e-4 of
// max|ref|). One block owns a 128 x 32 tile; each thread gathers 8
// channels of one position per step into shared memory (f32, transposed)
// and multiplies a 4x4 register tile.
//
// Tails: M, Ci and Co need not be multiples of the tile (Ci, Co = 48, 80,
// 96, 160, 320 ...): rows past M, channels past Ci and columns past Co are
// zero in shared memory and are not written back. Kt, Kh, Kw and the low
// pads are run-time arguments; output dims equal input dims.
//
// Layouts (row-major, contiguous): x (B,T,H,W,Ci); w (Kt*Kh*Kw,Ci,Co);
// out (B,T,H,W,Co); one dtype for all three: float (0) or bf16 (1);
// workspace (splits,M,Co) f32, needed only when splits > 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

struct Geom {
  int B, T, H, W, Ci, Co;
  int Kt, Kh, Kw;
  int pt, ph, pw;          // low pads
  long long M;             // B*T*H*W
};

// ---------------------------------------------------------------------------
// f32: FMA register tiles
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBM = 128;   // output positions per block
constexpr int kBN = 32;    // output channels per block
constexpr int kBK = 16;    // input channels per step
constexpr int kTM = 4;     // register tile: positions per thread
constexpr int kTN = 4;     // register tile: output channels per thread
constexpr int kLoad = 8;   // input channels one thread gathers per step

static_assert(kThreads == kBM * (kBK / kLoad), "one gather per thread");
static_assert(kThreads == (kBM / kTM) * (kBN / kTN), "one tile per thread");

__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, Geom g, int vec) {
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
        const float* src = x;
        if (valid)
          src = x + (((size_t(lb) * g.T + tt) * g.H + hh) * g.W + ww) *
                        size_t(g.Ci);
        const float* wt = w + size_t(tap) * g.Ci * g.Co;

        for (int c0 = 0; c0 < g.Ci; c0 += kBK) {
          float v[kLoad];
          const int c = c0 + lk;
          if (!valid) {
#pragma unroll
            for (int j = 0; j < kLoad; ++j) v[j] = 0.f;
          } else if (vec && c + kLoad <= g.Ci) {
            const float4 a = *reinterpret_cast<const float4*>(src + c);
            const float4 b = *reinterpret_cast<const float4*>(src + c + 4);
            v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
            v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
          } else {
#pragma unroll
            for (int j = 0; j < kLoad; ++j)
              v[j] = c + j < g.Ci ? src[c + j] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kLoad; ++j) As[lk + j][lrow] = v[j];
          for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
            const int k = idx / kBN, n = idx % kBN;
            const int ci = c0 + k, co = co0 + n;
            Bs[k][n] = (ci < g.Ci && co < g.Co)
                           ? wt[size_t(ci) * g.Co + co] : 0.f;
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
      if (co < g.Co) out[size_t(m) * g.Co + co] = acc[i][j];
    }
  }
}

int launch_f32(const void* x, const void* w, void* out, const Geom& g,
               cudaStream_t stream) {
  const long long m_tiles = (g.M + kBM - 1) / kBM;
  const int n_tiles = (g.Co + kBN - 1) / kBN;
  if (m_tiles > 2147483647LL || n_tiles > 65535)
    return int(cudaErrorInvalidValue);
  // 16-byte gathers need every position's channel row aligned
  const int vec = (g.Ci % kLoad == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  dim3 grid((unsigned)m_tiles, (unsigned)n_tiles);
  conv_f32_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), g, vec);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kMmaThreads = 128;            // 4 warps: 2 along M x 2 along N
constexpr int kTileM = 128;                 // output positions per block
constexpr int kStepK = 32;                  // input channels per stage
constexpr int kStages = 3;
constexpr int kAPitch = kStepK + 8;         // bf16 per A row in shared memory
constexpr int kSumThreads = 256;

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

template <int NT>   // n8 tiles per warp; the block tile is 128 x 16*NT
struct MmaTile {
  static constexpr int kN = 16 * NT;
  static constexpr int kBPitch = kN + 8;      // bf16 per B row in shared
  static constexpr int kAElems = kTileM * kAPitch;
  static constexpr int kStageElems = kAElems + kStepK * kBPitch;
  static constexpr size_t kSmemBytes = size_t(kStages) * kStageElems * 2;
};

template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
conv_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 bf16* __restrict__ out, float* __restrict__ part, Geom g,
                 int vec_a, int vec_b, int splits) {
  typedef MmaTile<NT> Tile;
  constexpr int kBChunks = Tile::kN / 8;      // 16-byte chunks per B row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const long long m0 = (long long)blockIdx.x * kTileM;
  const int n0 = blockIdx.y * Tile::kN;
  const int split = blockIdx.z;
  const int taps = g.Kt * g.Kh * g.Kw;
  const int tap_lo = split * taps / splits;
  const int tap_hi = (split + 1) * taps / splits;
  const int steps = (tap_hi - tap_lo) * ((g.Ci + kStepK - 1) / kStepK);
  const bf16 zero = __float2bfloat16(0.f);

  // A copy role: channels [ac, ac + 8) of tile rows tid/4 + 32 j. A row
  // past M gets a T index that no tap brings into the clip.
  const int ac = (tid & 3) * 8;
  const bf16* arow[4];
  int at[4], ah[4], aw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long m = m0 + (tid >> 2) + 32 * j;
    arow[j] = x;
    at[j] = -(1 << 28); ah[j] = 0; aw[j] = 0;
    if (m < g.M) {
      long long r = m;
      aw[j] = int(r % g.W); r /= g.W;
      ah[j] = int(r % g.H); r /= g.H;
      at[j] = int(r % g.T);
      arow[j] = x + size_t(m) * g.Ci;
    }
  }

  // the step the next copy fills: tap (ldt, ldh, ldw), channels lc0..
  int ldw = tap_lo % g.Kw, ldh = (tap_lo / g.Kw) % g.Kh;
  int ldt = tap_lo / (g.Kw * g.Kh), lc0 = 0;

  auto load_step = [&](int stage) {
    bf16* As = smem + stage * Tile::kStageElems;
    bf16* Bs = As + Tile::kAElems;
    const long long shift =
        ((long long)(ldt - g.pt) * g.H + (ldh - g.ph)) * g.W + (ldw - g.pw);
    const int c = lc0 + ac;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tt = at[j] + ldt - g.pt;
      const int hh = ah[j] + ldh - g.ph;
      const int ww = aw[j] + ldw - g.pw;
      const bool pos = (unsigned)tt < (unsigned)g.T &&
                       (unsigned)hh < (unsigned)g.H &&
                       (unsigned)ww < (unsigned)g.W;
      bf16* dst = As + ((tid >> 2) + 32 * j) * kAPitch + ac;
      const bf16* src = arow[j] + shift * g.Ci + c;
      if (vec_a) {
        const bool ok = pos && c < g.Ci;
        cp_async16(smem_addr(dst), ok ? src : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = pos && c + e < g.Ci ? src[e] : zero;
      }
    }
    const bf16* wt =
        w + size_t((ldt * g.Kh + ldh) * g.Kw + ldw) * g.Ci * g.Co;
    for (int q = tid; q < kStepK * kBChunks; q += kMmaThreads) {
      const int row = q / kBChunks, col = (q % kBChunks) * 8;
      const int ci = lc0 + row, co = n0 + col;
      bf16* dst = Bs + row * Tile::kBPitch + col;
      const bf16* src = wt + size_t(ci) * g.Co + co;
      if (vec_b) {
        const bool ok = ci < g.Ci && co < g.Co;
        cp_async16(smem_addr(dst), ok ? src : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = ci < g.Ci && co + e < g.Co ? src[e] : zero;
      }
    }
    lc0 += kStepK;
    if (lc0 >= g.Ci) {
      lc0 = 0;
      if (++ldw == g.Kw) {
        ldw = 0;
        if (++ldh == g.Kh) { ldh = 0; ++ldt; }
      }
    }
  };

  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();   // this step's copies have landed
    __syncthreads();                // ... for every thread; and the stage
                                    // refilled below is no longer read
    if (it + kStages - 1 < steps) load_step((it + kStages - 1) % kStages);
    cp_async_commit();

    const bf16* As = smem + (it % kStages) * Tile::kStageElems;
    const uint32_t a_addr = smem_addr(As);
    const uint32_t b_addr = smem_addr(As + Tile::kAElems);
#pragma unroll
    for (int kk = 0; kk < kStepK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm * 64 + mt * 16 + (lane & 15);
        const int col = kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(af[mt], a_addr + (row * kAPitch + col) * 2);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t bfr[4];
        const int row = kk * 16 + (lane & 15);
        const int col = wn * (8 * NT) + p * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bfr, b_addr + (row * Tile::kBPitch + col) * 2);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * p], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * p + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: rows lane/4 and lane/4 + 8 of each m16 tile, columns
  // 2*(lane%4) and +1 of each n8 tile; pairs stored together where Co is
  // even (then a pair never straddles Co)
  const bool pairs = (g.Co & 1) == 0;
  float* part_z = part + size_t(split) * size_t(g.M) * g.Co;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m =
          m0 + wm * 64 + mt * 16 + (lane >> 2) + 8 * half;
      if (m >= g.M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = n0 + wn * (8 * NT) + nt * 8 + 2 * (lane & 3);
        if (co >= g.Co) continue;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        const size_t o = size_t(m) * g.Co + co;
        if (splits > 1) {
          if (pairs) {
            *reinterpret_cast<float2*>(part_z + o) = make_float2(v0, v1);
          } else {
            part_z[o] = v0;
            if (co + 1 < g.Co) part_z[o + 1] = v1;
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
}

// out[i] = round(part[0][i] + part[1][i] + ... + part[splits-1][i]), in
// that order
__global__ void __launch_bounds__(kSumThreads)
conv_split_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                      long long n, int splits) {
  for (long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kSumThreads) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[k * n + i];
    out[i] = __float2bfloat16(s);
  }
}

template <int NT>
int launch_bf16(const void* x, const void* w, void* out, void* part,
                const Geom& g, int splits, cudaStream_t stream) {
  typedef MmaTile<NT> Tile;
  const long long m_tiles = (g.M + kTileM - 1) / kTileM;
  const int n_tiles = (g.Co + Tile::kN - 1) / Tile::kN;
  if (m_tiles > 2147483647LL || n_tiles > 65535 || splits < 1 ||
      splits > g.Kt * g.Kh * g.Kw || splits > 65535 ||
      (splits > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv_bf16_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(Tile::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  // 16-byte copies need every row of 8 channels whole and aligned
  const int vec_a = (g.Ci % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int vec_b = (g.Co % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  dim3 grid((unsigned)m_tiles, (unsigned)n_tiles, (unsigned)splits);
  conv_bf16_kernel<NT><<<grid, kMmaThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), static_cast<float*>(part), g, vec_a, vec_b,
      splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  const long long n = g.M * g.Co;
  long long blocks = (n + kSumThreads - 1) / kSumThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  conv_split_sum_kernel<<<(unsigned)blocks, kSumThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<bf16*>(out), n, splits);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// pt, ph, pw are the low pads; output dims equal input dims. bf16 only:
// tile_n (64 or 96) is the block's width in output channels, splits the
// number of contiguous tap ranges over which K is split, and workspace
// holds splits*M*Co floats when splits > 1 (else it may be null). The f32
// path takes splits = 1 and ignores tile_n. Returns 0, or the CUDA error of
// the launch (cudaErrorInvalidValue for a shape or plan the kernels do not
// take).
extern "C" int fc_conv_s1(const void* x, const void* w, void* out, int dtype,
                          int B, int T, int H, int W, int Ci, int Co, int Kt,
                          int Kh, int Kw, int pt, int ph, int pw, int tile_n,
                          int splits, void* workspace, void* stream) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || Kt < 1 ||
      Kh < 1 || Kw < 1 || pt < 0 || ph < 0 || pw < 0 || pt >= Kt ||
      ph >= Kh || pw >= Kw)
    return int(cudaErrorInvalidValue);
  Geom g;
  g.B = B; g.T = T; g.H = H; g.W = W; g.Ci = Ci; g.Co = Co;
  g.Kt = Kt; g.Kh = Kh; g.Kw = Kw; g.pt = pt; g.ph = ph; g.pw = pw;
  g.M = (long long)B * T * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && splits == 1) return launch_f32(x, w, out, g, st);
  if (dtype == 1 && tile_n == 64)
    return launch_bf16<4>(x, w, out, workspace, g, splits, st);
  if (dtype == 1 && tile_n == 96)
    return launch_bf16<6>(x, w, out, workspace, g, splits, st);
  return int(cudaErrorInvalidValue);
}
