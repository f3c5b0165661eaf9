// K3 in bf16 on Hopper: K <= 4 consecutive LocalNonLinearBlocks of the
// flagship, CHW, in one persistent cooperative launch. Replaces
// irdu_tpu/ops/pallas/block_stack.py:fused_block_stack (_kernel). The block,
// its rounding points, the bound and the plan are set out in
// irdu_tpu_torch/ops/block_stack.py. (f32 K3, and shapes outside the ones
// below, run on block_stack.cu.)
//
// The K blocks run as K phases, one block each, separated by grid barriers.
// Phase 0 reads bf16 x (CHW); phase k writes its f32 output to scratch
// S[k & 1] (the wrapper's, ping-pong, channels-last: a pixel's C values
// contiguous, so that a thread reads and writes them 16 and 8 bytes at a
// time, where CHW made it gather from C planes a megabyte apart) and phase
// k + 1 reads it back through L2 (ld.global.cg: another CTA wrote it); the
// last phase writes bf16 out (CHW). So the activation is rounded once, at
// the end, and each block needs
// only a 1-pixel halo: a tile's taps run on its own pixels and its expand on
// the tile plus that halo (1.4x at 8x16 tiles), where block_stack.cu's
// K-pixel halo ran the taps on 1.6x and the expand on 2.0x the pixels.
//
// One CTA per SM (the grid is as many CTAs as fit at once, at most one per
// tile), 384 threads: two consumer warpgroups (232 registers a thread,
// setmaxnreg) and a producer warpgroup (40) of which one thread issues the
// TMA loads. At the start of phase k that thread loads block k's whole
// w1^T (2H x C) and w2^T (C x H), chunk by chunk, into shared memory; the
// consumers wait for chunk j's barrier at parity k & 1, and the grid barrier
// at the end of the phase frees the weights for the next block's. The CTA
// then walks the phase's output tiles (th x tw <= 128 pixels, the region
// with its halo <= 192 pixels) with K4's body (gated_block.cu), at C in
// {16, 32, 48, 64} and H a multiple of 32 up to 128:
//   - the norm of the region from global memory into Y0 (bf16, K-major,
//     128-byte swizzle), one thread per pixel, two-pass variance, ddof 1,
//     mean not subtracted, over each subnet's C / ns channels (a runtime
//     count, masked passes over the registers when ns > 1);
//   - per chunk of hc = 32 m-channels and their 32 u-channels, the expand
//     transposed on wgmma (M = 64 hidden rows, N = 96 region pixels per
//     warpgroup, over C), queued a chunk ahead; the f32 taps (clamped to the
//     region: the replicate pad at an image edge) and gate into Y3 (bf16);
//     the project on wgmma (m64nCk16 over hc) into a register accumulator
//     held across the chunks;
//   - the epilogue s0 x + s1 acc, x the block's input, which the norm left
//     in shared memory (Xt), written once per output.
// Shared memory, every part 1024-byte aligned:
//   Y0   bf16 (192, 64)      the region's normalized input (columns C..63 unused)
//   W1   nch x 8 KB          w1^T chunks: 64 rows (m, then u) x 64 channels,
//                            128-byte swizzle; channels C..63 zero (TMA fill)
//   W2   nch x C x 64 bytes  w2^T chunks: C rows x 32 hidden, 64-byte swizzle
//   Y1   f32 (192, 64 + 8)   a chunk's expand, m columns then u columns
//   Y3   bf16 (128, 32)      a chunk's gate output, 64-byte swizzle
//   Xt   f32 (128, C + 4)    the tile's input, kept by the norm for the epilogue
//   nch mbarriers, one per weight chunk

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>

#include "hopper.cuh"

namespace irdu {
namespace stack {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kHc = 32;                     // hidden channels per chunk
constexpr int kMaxChunks = 4;               // H <= 128
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kY1Ld = 72;                   // f32 row stride of Y1: 64 + 8
constexpr int kMr = 192;                    // expand rows: the region's pixels, padded
constexpr int kMp = 128;                    // project rows: the tile's pixels, padded
constexpr int kNe = kMr / 2;                // expand pixels per warpgroup
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ void consumer_sync() { named_sync<kConsumers>(); }

// Shared-memory layout; must match irdu_tpu_torch/ops/block_stack.py:stack_smem_bytes.
struct Layout {
  size_t y0, w1, w2, slot2, y1, y3, xt, bars, total;
};

// Row stride (floats) of Xt: C + 4, so that the norm's 16-byte writes of 8
// consecutive pixels hit 32 different banks.
__host__ __device__ constexpr int xt_ld(int C) { return C + 4; }

__host__ __device__ inline Layout layout(int C, int nch) {
  Layout L;
  L.y0 = 0;
  L.w1 = align1k((size_t)kMr * 128);
  L.slot2 = align1k((size_t)C * kHc * 2);
  L.w2 = L.w1 + (size_t)nch * 8192;
  L.y1 = L.w2 + nch * L.slot2;
  L.y3 = L.y1 + align1k((size_t)kMr * kY1Ld * 4);
  L.xt = L.y3 + align1k((size_t)kMp * kHc * 2);
  L.bars = L.xt + align1k((size_t)kMp * xt_ld(C) * 4);
  L.total = L.bars + kMaxChunks * 8 + 1024;  // + slack to align the base
  return L;
}

struct Args {
  const bf16* x;        // (B, C, H, W), phase 0's input
  bf16* out;            // (B, C, H, W), the last phase's output
  float* scratch[2];    // (B, H, W, C) f32 each, phases 0..K-2 write S[k & 1]
  const float* scale;   // (K, C)
  const float* dwk;     // (K, 9, 2H)
  const float* skip;    // (K, 2)
  int B, H, W, K, nh, th, tw, tiles_x, tiles_y;
  int ns;  // subnets: the norm runs over each run of C / ns channels
};

// Issue the expand of chunk j (its weights loaded in phase k), transposed
// so that the chunk's 2hc = 64 hidden channels are wgmma's M and the pixels
// its N: D (64 x 96) = w1^T chunk (64 x C) . y0^T over this warpgroup's 96
// region pixels, m64n96k16 over C, one committed group.
template <int kC>
__device__ __forceinline__ void expand(float (&acc)[kNe / 2], uint32_t w1, uint32_t y0,
                                       uint64_t* full, int wg, int j, int k) {
  mbar_wait(full + j, k & 1);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kC / 16; ++ks)
    wgmma_n96(acc, mdesc(w1 + j * 8192 + ks * 32, 1024, kSw128),
              mdesc(y0 + wg * kNe * 128 + ks * 32, 1024, kSw128), ks > 0);
  wgmma_commit();
}

// After the expand is waited for: store this warpgroup's pixels to Y1 (f32,
// [pixel][hidden]) and meet the other warpgroup.
__device__ __forceinline__ void store_expand(float (&acc)[kNe / 2], float* Y1, int wg, int wi,
                                             int lane) {
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < kNe / 2; ++i) {
    const int h = wi * 16 + lane / 4 + 8 * ((i % 4) / 2);
    const int p = wg * kNe + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
    Y1[p * kY1Ld + h] = acc[i];
  }
  consumer_sync();
}

// The 3x3 taps of hidden channel hm (m) and nh + hm (u) of a (9, 2nh) table.
__device__ __forceinline__ void tap_weights(const float* dwk, int hm, int nh, float (&m)[9],
                                            float (&u)[9]) {
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    m[t] = dwk[t * 2 * nh + hm];
    u[t] = dwk[t * 2 * nh + nh + hm];
  }
}

// One output tile of block k (the consumers' part of a phase).
template <int kC>
__device__ __forceinline__ void tile(const Args& a, int k, int t, unsigned char* sm,
                                     const Layout& L, uint64_t* full) {
  unsigned char* Y0 = sm + L.y0;
  float* Y1 = reinterpret_cast<float*>(sm + L.y1);
  unsigned char* Y3 = sm + L.y3;
  float* Xt = reinterpret_cast<float*>(sm + L.xt);
  const int H = a.H, W = a.W, nh = a.nh, nch = nh / kHc;
  const int tid = threadIdx.x, wg = tid / 128, wi = (tid % 128) / 32, lane = tid % 32;
  const int per_plane = a.tiles_x * a.tiles_y;
  const int b = t / per_plane, tyx = t - b * per_plane, ty = tyx / a.tiles_x;
  const int tx = tyx - ty * a.tiles_x;
  // tile [ti0, ti1) x [tj0, tj1); region [r0, r1) x [c0, c1)
  const int ti0 = ty * a.th, tj0 = tx * a.tw;
  const int ti1 = min(ti0 + a.th, H), tj1 = min(tj0 + a.tw, W);
  const int r0 = max(ti0 - 1, 0), r1 = min(ti1 + 1, H);
  const int c0 = max(tj0 - 1, 0), c1 = min(tj1 + 1, W);
  const int rh = r1 - r0, rw = c1 - c0, nr = rh * rw;
  const size_t plane = (size_t)H * W, boff = (size_t)b * kC * plane;
  const bool first = k == 0, last = k == a.K - 1;
  const bf16* xb = a.x + boff;                         // phase 0's input
  const float* xf = a.scratch[(k + 1) & 1] + boff;     // later phases' (S[(k - 1) & 1])
  const float* scale = a.scale + k * kC;

  // the previous tile is done with Y0, Y1 and Y3
  consumer_sync();
  // CustomLayerNorm of the region into Y0, one thread per region pixel,
  // holding its kC channels in registers; rows nr..kMr of Y0 are zero, Y3
  // is zeroed (rows of pixels outside a ragged tile stay zero)
  for (int c = tid; c < kC; c += kConsumers) Y1[c] = scale[c];
  consumer_sync();
  {
    const int p = tid;
    const bool active = p < nr;
    const int i = active ? p / rw : 0, jj = active ? p - i * rw : 0;
    const size_t src = (size_t)(r0 + i) * W + c0 + jj;
    float v[kC];
    if (first) {
#pragma unroll
      for (int c = 0; c < kC; ++c) v[c] = active ? __bfloat162float(xb[c * plane + src]) : 0.f;
    } else {
      const float4* q = reinterpret_cast<const float4*>(xf + src * kC);
#pragma unroll
      for (int c = 0; c < kC; c += 4) {
        const float4 t = active ? __ldcg(q + c / 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[c] = t.x, v[c + 1] = t.y, v[c + 2] = t.z, v[c + 3] = t.w;
      }
    }
    float inv = 1.f;
    if (a.ns == 1) {
      float acc8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // 8 chains
#pragma unroll
      for (int c = 0; c < kC; ++c) acc8[c % 8] += v[c];
      const float mean =
          (((acc8[0] + acc8[1]) + (acc8[2] + acc8[3])) + ((acc8[4] + acc8[5]) + (acc8[6] + acc8[7]))) / kC;
#pragma unroll
      for (int q = 0; q < 8; ++q) acc8[q] = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float d = v[c] - mean;
        acc8[c % 8] = fmaf(d, d, acc8[c % 8]);
      }
      const float var =
          ((acc8[0] + acc8[1]) + (acc8[2] + acc8[3])) + ((acc8[4] + acc8[5]) + (acc8[6] + acc8[7]));
      inv = 1.f / sqrtf(var / (kC - 1) + 1e-5f);
    }
    const int ti = i - (ti0 - r0), tj = jj - (tj0 - c0);  // the pixel's place in the tile
    if (active && ti >= 0 && ti < ti1 - ti0 && tj >= 0 && tj < tj1 - tj0) {
      float4* xt = reinterpret_cast<float4*>(Xt + (ti * a.tw + tj) * xt_ld(kC));
#pragma unroll
      for (int c = 0; c < kC; c += 4) xt[c / 4] = make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
    }
    if (a.ns > 1) {
      // per subnet (runs of cs = C / ns channels): the same two passes over
      // the channels of run [lo, lo + cs) picked by a mask, then v scaled in
      // place by the run's 1 / sqrt(var + eps) (Xt already holds x)
      const int cs = kC / a.ns;
      for (int lo = 0; lo < kC; lo += cs) {
        float acc4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kC; ++c) acc4[c % 4] += (c >= lo && c < lo + cs) ? v[c] : 0.f;
        const float mean = ((acc4[0] + acc4[1]) + (acc4[2] + acc4[3])) / cs;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc4[q] = 0.f;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float d = (c >= lo && c < lo + cs) ? v[c] - mean : 0.f;
          acc4[c % 4] = fmaf(d, d, acc4[c % 4]);
        }
        const float r = 1.f / sqrtf(((acc4[0] + acc4[1]) + (acc4[2] + acc4[3])) / (cs - 1) + 1e-5f);
#pragma unroll
        for (int c = 0; c < kC; ++c) v[c] = (c >= lo && c < lo + cs) ? v[c] * r : v[c];
      }
    }
    if (p < kMr) {
#pragma unroll
      for (int g = 0; g < kC / 8; ++g) {
        uint4 o;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 8 * g + 2 * q;
          e[q] = active ? __floats2bfloat162_rn(v[c] * inv * Y1[c], v[c + 1] * inv * Y1[c + 1])
                        : __floats2bfloat162_rn(0.f, 0.f);
        }
        *reinterpret_cast<uint4*>(Y0 + sw128(p, 8 * g)) = o;
      }
    }
    for (int idx = tid; idx < kMp * kHc * 2 / 16; idx += kConsumers)
      reinterpret_cast<uint4*>(Y3)[idx] = make_uint4(0, 0, 0, 0);
  }
  fence_async_smem();
  consumer_sync();

  const int npx = a.th * a.tw;
  const int tw_act = tj1 - tj0, th_act = ti1 - ti0;
  const uint32_t y0_u32 = smem_u32(Y0), y3_u32 = smem_u32(Y3);
  const uint32_t w1_u32 = smem_u32(sm + L.w1), w2_u32 = smem_u32(sm + L.w2);
  const int ch = tid % 32, pg = tid / 32;  // the taps: one hidden channel, column group
  const float* dwk = a.dwk + (size_t)k * 9 * 2 * nh;
  float accE[kNe / 2];
  float accP[kC / 2];

  expand<kC>(accE, w1_u32, y0_u32, full, wg, 0, k);
  wgmma_wait<0>();
  store_expand(accE, Y1, wg, wi, lane);
  // this thread's tap weights (m and u channel) of chunk j, loaded a chunk ahead
  float km[9], ku[9], kmn[9], kun[9];
  tap_weights(dwk, ch, nh, km, ku);
  for (int j = 0; j < nch; ++j) {
    const bool more = j + 1 < nch;
    if (more) tap_weights(dwk, (j + 1) * kHc + ch, nh, kmn, kun);
    if (more) {  // the next chunk's expand, queued on the tensor cores first
      expand<kC>(accE, w1_u32, y0_u32, full, wg, j + 1, k);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    if (j > 0) fence_regs(accP);  // the previous chunk's project is done: Y3 is free
    consumer_sync();
    // taps and gate: one hidden channel a thread and two adjacent columns,
    // 2pg and 2pg + 1 (then 16 further on), sliding a 4-row by 4-column
    // window of the m and u planes down them two rows at a time: 16 loads
    // for 8 outputs, four independent chains
    for (int tj = 2 * pg; tj < tw_act; tj += 16) {
      const int rj = tj0 + tj - c0;
      const bool two = tj + 1 < tw_act;
      const float* cm[4];  // the Y1 columns rj - 1 .. rj + 2, at region row 0
#pragma unroll
      for (int db = 0; db < 4; ++db)
        cm[db] = Y1 + (min(max(rj - 1 + db, 0), rw - 1)) * kY1Ld + ch;
      const int ri0 = ti0 - r0, rs = rw * kY1Ld;  // rs: one region row of Y1
      float wm[4][4], wu[4][4];
#pragma unroll
      for (int dr = 0; dr < 2; ++dr) {
        const int ro = min(max(ri0 - 1 + dr, 0), rh - 1) * rs;
#pragma unroll
        for (int db = 0; db < 4; ++db) {
          wm[dr][db] = cm[db][ro];
          wu[dr][db] = cm[db][ro + 32];
        }
      }
#pragma unroll 2
      for (int ti = 0; ti < th_act; ti += 2) {
#pragma unroll
        for (int dr = 2; dr < 4; ++dr) {
          const int ro = min(ri0 + ti + dr - 1, rh - 1) * rs;
#pragma unroll
          for (int db = 0; db < 4; ++db) {
            wm[dr][db] = cm[db][ro];
            wu[dr][db] = cm[db][ro + 32];
          }
        }
#pragma unroll
        for (int o = 0; o < 2; ++o) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float mr3[3], ur3[3];  // one partial sum per window row: short chains
#pragma unroll
            for (int dr = 0; dr < 3; ++dr) {
              mr3[dr] = wm[o + dr][cc] * km[3 * dr];
              ur3[dr] = wu[o + dr][cc] * ku[3 * dr];
#pragma unroll
              for (int db = 1; db < 3; ++db) {
                mr3[dr] = fmaf(wm[o + dr][cc + db], km[3 * dr + db], mr3[dr]);
                ur3[dr] = fmaf(wu[o + dr][cc + db], ku[3 * dr + db], ur3[dr]);
              }
            }
            const float m = (mr3[0] + mr3[1]) + mr3[2], u = (ur3[0] + ur3[1]) + ur3[2];
            if ((o == 0 || ti + 1 < th_act) && (cc == 0 || two))
              *reinterpret_cast<bf16*>(Y3 + sw64((ti + o) * a.tw + tj + cc, ch)) =
                  __float2bfloat16(__frcp_rn(1.f + __expf(-m)) * m * u);
          }
        }
#pragma unroll
        for (int db = 0; db < 4; ++db) {
          wm[0][db] = wm[2][db];
          wm[1][db] = wm[3][db];
          wu[0][db] = wu[2][db];
          wu[1][db] = wu[3][db];
        }
      }
    }
    fence_async_smem();
    consumer_sync();
    // project: acc[p][n] += sum_i Y3[p][i] w2^T[n][i] (chunk j's weights
    // landed with its expand's)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHc / 16; ++kk)
      wgmma_project<kC>(accP, mdesc(y3_u32 + wg * 64 * 64 + kk * 32, 512, kSw64),
                        mdesc(w2_u32 + j * L.slot2 + kk * 32, 512, kSw64), j > 0 || kk > 0);
    wgmma_commit();
    if (more) {  // the next chunk's expand (committed before this project) is done
      wgmma_wait<1>();
      store_expand(accE, Y1, wg, wi, lane);
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        km[q] = kmn[q];
        ku[q] = kun[q];
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(accP);

  // epilogue: s0 x + s1 acc over the tile's pixels, x this block's input
  // from Xt; registers i and i + 1 (i even) hold channels n and n + 1 of
  // one pixel
  const float s0 = a.skip[2 * k], s1 = a.skip[2 * k + 1];
  bf16* outb = a.out + boff;
  float* outf = a.scratch[k & 1] + boff;
#pragma unroll
  for (int i = 0; i < kC / 2; i += 2) {
    const int p = wg * 64 + wi * 16 + lane / 4 + 8 * ((i % 4) / 2);
    const int n = 8 * (i / 4) + 2 * (lane % 4);
    const int ti = p / a.tw, tj = p - ti * a.tw;
    if (p < npx && ti < th_act && tj < tw_act) {
      const size_t px = (size_t)(ti0 + ti) * W + tj0 + tj;
      const float2 xv = *reinterpret_cast<const float2*>(Xt + p * xt_ld(kC) + n);
      const float y0 = fmaf(s1, accP[i], s0 * xv.x), y1 = fmaf(s1, accP[i + 1], s0 * xv.y);
      if (last) {
        outb[n * plane + px] = __float2bfloat16(y0);
        outb[(n + 1) * plane + px] = __float2bfloat16(y1);
      } else {
        *reinterpret_cast<float2*>(outf + px * kC + n) = make_float2(y0, y1);
      }
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
    stack_kernel(const __grid_constant__ CUtensorMap w1map,
                 const __grid_constant__ CUtensorMap w2map, Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* sm = smem_raw + pad;
  const int nch = a.nh / kHc;
  const Layout L = layout(kC, nch);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  const int tid = threadIdx.x;
  const int tiles = a.B * a.tiles_y * a.tiles_x;
  // the warpgroup, broadcast from lane 0 so that the compiler sees the role
  // branch as warp-uniform (otherwise it serializes every wgmma behind it)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int j = 0; j < nch; ++j) mbar_init(full + j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the two roles run apart, each with its own phase loop, so that ptxas
  // can hold the producer to 40 registers; both meet at every grid barrier
  cg::grid_group grid = cg::this_grid();
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    for (int k = 0; k < a.K; ++k) {
      if (tid == kConsumers) {  // block k's weights, each chunk on its barrier
        for (int j = 0; j < nch; ++j) {
          mbar_expect_tx(full + j, 64 * 128 + kC * kHc * 2);
          unsigned char* w1s = sm + L.w1 + j * 8192;
          tma_load(w1s, &w1map, 0, k * 2 * a.nh + j * kHc, full + j);
          tma_load(w1s + 4096, &w1map, 0, k * 2 * a.nh + a.nh + j * kHc, full + j);
          tma_load(sm + L.w2 + j * L.slot2, &w2map, j * kHc, k * kC, full + j);
        }
      }
      if (k + 1 < a.K) grid.sync();  // block k's output is complete everywhere
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    for (int k = 0; k < a.K; ++k) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) tile<kC>(a, k, t, sm, L, full);
      if (k + 1 < a.K) grid.sync();
    }
  }
}

char g_error[256] = "";

// The CTAs that fit on one SM and the SM count, found once per device (the
// shared memory limit raised to the most a block has first).
template <int kC>
cudaError_t occupancy(int* per_sm, int* sms) {
  constexpr int kDevices = 64;
  static int cached_per_sm[kDevices], cached_sms[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached_sms[dev] > 0) {
    *per_sm = cached_per_sm[dev];
    *sms = cached_sms[dev];
    return cudaSuccess;
  }
  auto kern = stack_kernel<kC>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads,
                                                        layout(kC, kMaxChunks).total);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) {
    cached_per_sm[dev] = *per_sm;
    cached_sms[dev] = *sms;
  }
  return err;
}

// A refused cooperative launch (too many CTAs to be co-resident) returns its
// error; nothing falls back.
template <int kC>
int launch(Args a, const void* w1t, const void* w2t, cudaStream_t stream) {
  CUtensorMap m1, m2;
  if (!encode(&m1, w1t, a.K * 2 * a.nh, kC, kC, kHc, 64, CU_TENSOR_MAP_SWIZZLE_128B, "w1",
              g_error, sizeof g_error) ||
      !encode(&m2, w2t, a.K * kC, a.nh, a.nh, kC, kHc, CU_TENSOR_MAP_SWIZZLE_64B, "w2",
              g_error, sizeof g_error))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy<kC>(&per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int tiles = a.B * a.tiles_y * a.tiles_x;
  const int grid = std::min(tiles, per_sm * sms);
  void* params[] = {&m1, &m2, &a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stack_kernel<kC>), dim3(grid), dim3(kThreads), params,
      layout(kC, a.nh / kHc).total, stream));
}

}  // namespace stack
}  // namespace irdu

// Why the last launch was refused before reaching CUDA ("" if it was not).
extern "C" const char* irdu_block_stack_wgmma_error() { return irdu::stack::g_error; }

// Shared memory of one CTA at C and hidden width nh (the plan's check).
extern "C" long long irdu_block_stack_wgmma_smem(int C, int nh) {
  return static_cast<long long>(irdu::stack::layout(C, nh / irdu::stack::kHc).total);
}

// x, out (B, C, H, W) bf16; scratch 2 (K >= 3), 1 (K = 2) or 0 buffers of
// B * H * W * C f32; scale (K, C), dwk (K, 9, 2nh) and skip (K, 2) f32; w1t
// (K, 2nh, C) and w2t (K, C, nh) bf16, all contiguous; a th x tw tile (the
// plan of block_stack.plan_stack_tiles); ns the norm's subnets, runs of
// C / ns >= 2 channels.
extern "C" int irdu_block_stack_wgmma(const void* x, void* out, void* scratch,
                                      const void* scale, const void* w1t, const void* dwk,
                                      const void* w2t, const void* skip, int B, int C, int H,
                                      int W, int K, int nh, int th, int tw, int ns,
                                      void* stream) {
  using namespace irdu::stack;
  g_error[0] = '\0';
  const int region = std::min(th + 2, H) * std::min(tw + 2, W);
  const bool aligned = reinterpret_cast<uintptr_t>(w1t) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w2t) % 16 == 0;
  if (B < 1 || H < 1 || W < 1 || K < 1 || K > 4 || nh < kHc || nh % kHc ||
      nh > kMaxChunks * kHc || th < 1 || tw < 1 || th * tw > kMp || region > kMr || !aligned ||
      (K > 1 && scratch == nullptr) || ns < 1 || C % ns || C / ns < 2) {
    snprintf(g_error, sizeof g_error, "plan or operands not taken: C=%d H=%d K=%d th=%d tw=%d",
             C, nh, K, th, tw);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* s = static_cast<float*>(scratch);
  const size_t n = (size_t)B * C * H * W;
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
         {s, K > 2 ? s + n : s}, static_cast<const float*>(scale),
         static_cast<const float*>(dwk), static_cast<const float*>(skip), B, H, W, K, nh, th, tw,
         (W + tw - 1) / tw, (H + th - 1) / th, ns};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16>(a, w1t, w2t, st);
    case 32: return launch<32>(a, w1t, w2t, st);
    case 48: return launch<48>(a, w1t, w2t, st);
    case 64: return launch<64>(a, w1t, w2t, st);
    default:
      snprintf(g_error, sizeof g_error, "C=%d: the kernel takes C in {16, 32, 48, 64}", C);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
