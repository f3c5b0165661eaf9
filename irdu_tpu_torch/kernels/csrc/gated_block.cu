// K4 in bf16: one LocalNonLinearBlock of the flagship, CHW, on Hopper's
// tensor cores. Replaces irdu_tpu/ops/pallas/gated_block.py:fused_gated_block
// (_kernel). The block, its rounding points, the bound and the plan are set
// out in irdu_tpu_torch/ops/gated_block.py. (f32 blocks and K3 run on
// block_stack.cu.)
//
// One CTA per output tile of th x tw pixels, 384 threads: two consumer
// warpgroups (232 registers a thread, setmaxnreg) and a producer warpgroup
// (40) of which one thread issues the TMA loads. The region is the tile plus
// a 1-pixel halo clipped to the image, nr <= mr pixels: mr = 192 (64 at
// C = 384), fixed at compile time, since ptxas serializes every wgmma that
// sits behind a runtime branch. Shared memory, every part 1024-byte aligned:
//   Y0    bf16 (mr, C)      the normalized input, K-major in 64-channel
//                           blocks, 128-byte swizzle (wgmma's B of the expand)
//   ring1 2 slots of a chunk's expand weights: 2hc = 64 rows of w1^T (the m
//         rows, then the u rows) per 64-channel block, 128-byte swizzle
//         (the expand's A)
//   ring2 2 slots of a chunk's project weights: C rows of w2^T by hc = 32
//         hidden, 64-byte swizzle
//   Y1    f32 (mr, 64 + 8)  a chunk's expand, m columns then u columns
//   Y3    bf16 (mp, 32)     a chunk's gate output, 64-byte swizzle (the
//                           project's A), mp = 128 (C <= 192) or 64
//   full/empty mbarriers of each ring
// The producer fills a slot by TMA once the consumers have released it (its
// expand, or its project, is done), and each load completes the slot's full
// barrier by its bytes. The consumers run the hidden loop in chunks j of
// hc = 32 m-channels and their 32 u-channels, one chunk ahead on the tensor
// cores:
//   - expand of chunk j + 1 is queued on the tensor cores: transposed, so
//     that the chunk's 64 hidden channels are wgmma's M and the pixels its
//     N, each warpgroup half of the mr region rows (m64n96k16, or m64n32k16
//     at C = 384, over C); then
//   - taps (3x3 depthwise, reads clamped to the region: the replicate pad at
//     an image edge) and gate sigma(m) m u of chunk j in f32 from Y1, rounded
//     to bf16 into Y3 for the tile's pixels;
//   - project of chunk j (wgmma m64n64k16 / m64n32k16 over hc) into the
//     accumulator, which stays in registers across the whole hidden loop:
//     warpgroup w holds rows 64w..64w+63 by all C columns (C <= 192), or all
//     64 rows by C/2 columns (C = 384): 96 registers a thread at most;
//   - the expand of chunk j + 1 is waited for and stored to Y1.
// The epilogue writes s0 x + s1 acc once, x read again from global memory.
// Before the loop the consumers read x's region from global memory into
// registers, one to four threads per pixel, normalize it (two-pass variance
// over C, ddof 1, mean not subtracted) and write y0, rounded to bf16, into
// Y0; with ns > 1 subnets the variance is each subnet's, over its C / ns
// channels.

#include <algorithm>
#include <cstdint>
#include <cstdio>

#include "hopper.cuh"

namespace irdu {
namespace gated {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kHc = 32;                     // hidden channels per chunk
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kY1Ld = 72;                   // f32 row stride of Y1: 64 + 8
constexpr int kStages = 2;                  // slots of each weight ring
constexpr size_t kSmemLimit = 232448;

__host__ __device__ constexpr int kblocks(int C) { return (C + 63) / 64; }
// Barrier among the two consumer warpgroups (the producer warp is not in it).
__device__ __forceinline__ void consumer_sync() { named_sync<kConsumers>(); }

// Shared-memory layout; must match irdu_tpu_torch/ops/gated_block.py:gated_smem_bytes.
struct Layout {
  size_t y0, ring1, slot1, ring2, slot2, y1, y3, bars, total;
};

__host__ __device__ inline Layout layout(int C, int mr, int mp) {
  Layout L;
  L.slot1 = (size_t)kblocks(C) * 64 * 128;  // 2hc rows x 128 bytes per channel block
  L.slot2 = align1k((size_t)C * kHc * 2);   // C rows x 64 bytes
  L.y0 = 0;
  L.ring1 = align1k((size_t)kblocks(C) * mr * 128);
  L.ring2 = L.ring1 + kStages * L.slot1;
  L.y1 = L.ring2 + kStages * L.slot2;
  L.y3 = L.y1 + align1k((size_t)mr * kY1Ld * 4);
  L.bars = L.y3 + align1k((size_t)mp * kHc * 2);
  L.total = L.bars + 4 * kStages * 8 + 1024;  // + slack to align the base
  return L;
}

struct Args {
  const bf16* x;
  bf16* out;
  const void* scale;  // (C,)
  const void* dwk;    // (9, 2H) by strides
  const void* skip;   // (2,)
  long long dw_st, dw_sh;
  int H, W, nh, th, tw;
  int ns;  // subnets: the norm runs over each run of C / ns channels
};

// The expand's rows (region pixels) for C: mr = 192 (C <= 192) or 64, fixed
// when the kernel is compiled, since ptxas serializes every wgmma that sits
// behind a branch on a runtime value. Each warpgroup takes half of them.
__host__ __device__ constexpr int expand_rows(int C) { return C > 192 ? 64 : 192; }

// Where a warpgroup's expand reads and writes: Y0, ring 1 and its
// barriers, Y1, and this thread's place.
struct ExpandAt {
  uint32_t y0, ring1, slot1;
  uint64_t *full1, *empty1;
  float* Y1;
  int wg, wi, lane;
};

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 96) wgmma_n96(d, a, b, acc);
  else wgmma_n32(d, a, b, acc);
}

// Issue the expand of chunk j once its weights have landed, transposed so
// that the chunk's 2hc = 64 hidden channels are wgmma's M and the pixels
// its N: D (64 x kN) = w1^T chunk (64 x C) . y0^T over this warpgroup's
// kN = mr / 2 region pixels, wgmma m64nNk16 over C, one committed group.
template <int kC, int kN>
__device__ __forceinline__ void expand(const ExpandAt& e, float (&acc)[kN / 2], int j) {
  constexpr int kMr = expand_rows(kC);
  const int s = j % kStages;
  const uint32_t w1s = e.ring1 + s * e.slot1;
  mbar_wait(e.full1 + s, (j / kStages) & 1);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kC / 16; ++ks) {
    const uint32_t kb = ks / 4, kk = ks % 4;
    wgmma_n<kN>(acc, mdesc(w1s + kb * 8192 + kk * 32, 1024, kSw128),
                mdesc(e.y0 + kb * kMr * 128 + e.wg * kN * 128 + kk * 32, 1024, kSw128), ks > 0);
  }
  wgmma_commit();
}

// After the expand of chunk j is waited for: release its slot, store this
// warpgroup's pixels to Y1 (f32, [pixel][hidden]), and meet the other
// warpgroup.
template <int kN>
__device__ __forceinline__ void store_expand(const ExpandAt& e, float (&acc)[kN / 2], int j) {
  fence_regs(acc);
  mbar_arrive(e.empty1 + j % kStages);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int h = e.wi * 16 + e.lane / 4 + 8 * ((i % 4) / 2);
    const int p = e.wg * kN + 8 * (i / 4) + 2 * (e.lane % 4) + (i % 2);
    e.Y1[p * kY1Ld + h] = acc[i];
  }
  consumer_sync();
}

// The 3x3 taps of hidden channel hm (m) and nh + hm (u) from dwk (9, 2nh)
// by strides (tap, channel), as stored: they are loaded a chunk ahead and
// converted to f32 only where they are used, so nothing waits on the loads.
template <typename P>
__device__ __forceinline__ void tap_weights(const P* dwk, long long st, long long sh, int hm,
                                            int nh, P (&m)[9], P (&u)[9]) {
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    m[t] = dwk[t * st + hm * sh];
    u[t] = dwk[t * st + (nh + hm) * sh];
  }
}

template <int kC, typename P>
__global__ void __launch_bounds__(kThreads, 1)
    gated_kernel(const __grid_constant__ CUtensorMap w1map,
                 const __grid_constant__ CUtensorMap w2map, Args a) {
  constexpr int KB = kblocks(kC);
  constexpr int kSplit = kC > 192 ? 2 : 1;  // warpgroups sharing one project M tile
  constexpr int kN = kC / kSplit;           // project columns per warpgroup
  constexpr int kN64 = kN / 64;             // ... in m64n64 pieces
  constexpr bool kN32 = kN % 64 == 32;      // and one m64n32 piece
  constexpr int kMr = expand_rows(kC);      // expand rows: the region's pixels, padded
  constexpr int kMp = kC > 192 ? 64 : 128;  // project rows: the tile's pixels, padded
  constexpr int kNe = kMr / 2;              // expand pixels per warpgroup
  constexpr int kBoxRows = kC / ((kC + 255) / 256);  // rows of one w2 box (<= 256)
  static_assert(kC % 32 == 0 && kN % 32 == 0 && kN64 >= 1, "C: a multiple of 32, >= 64");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* sm = smem_raw + pad;
  const Layout L = layout(kC, kMr, kMp);
  unsigned char* Y0 = sm + L.y0;
  float* Y1 = reinterpret_cast<float*>(sm + L.y1);
  unsigned char* Y3 = sm + L.y3;
  uint64_t* full1 = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty1 = full1 + kStages;
  uint64_t* full2 = empty1 + kStages;
  uint64_t* empty2 = full2 + kStages;

  const int H = a.H, W = a.W, nh = a.nh, nch = nh / kHc;
  const int tid = threadIdx.x;
  // the warpgroup, broadcast from lane 0 so that the compiler sees the role
  // branch as warp-uniform (otherwise it serializes every wgmma behind it)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full1 + s, 1);
      mbar_init(empty1 + s, kConsumers);
      mbar_init(full2 + s, 1);
      mbar_init(empty2 + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == 2) {  // the producer warpgroup: one thread keeps both rings filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      for (int j = 0; j < nch; ++j) {
        const int s = j % kStages, phase = (j / kStages - 1) & 1;
        if (j >= kStages) mbar_wait(empty1 + s, phase);
        mbar_expect_tx(full1 + s, KB * 64 * 128);
        unsigned char* w1s = sm + L.ring1 + s * L.slot1;
        for (int half = 0; half < 2; ++half)
          for (int kb = 0; kb < KB; ++kb)
            tma_load(w1s + kb * 8192 + half * 4096, &w1map, kb * 64, half * nh + j * kHc,
                     full1 + s);
        if (j >= kStages) mbar_wait(empty2 + s, phase);
        mbar_expect_tx(full2 + s, kC * kHc * 2);
        unsigned char* w2s = sm + L.ring2 + s * L.slot2;
        for (int r = 0; r < kC; r += kBoxRows)
          tma_load(w2s + r * kHc * 2, &w2map, j * kHc, r, full2 + s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // tile [ti0, ti1) x [tj0, tj1); region [r0, r1) x [c0, c1)
    const int ti0 = blockIdx.y * a.th, tj0 = blockIdx.x * a.tw;
    const int ti1 = min(ti0 + a.th, H), tj1 = min(tj0 + a.tw, W);
    const int r0 = max(ti0 - 1, 0), r1 = min(ti1 + 1, H);
    const int c0 = max(tj0 - 1, 0), c1 = min(tj1 + 1, W);
    const int rh = r1 - r0, rw = c1 - c0, nr = rh * rw;
    const size_t plane = (size_t)H * W;
    const bf16* x = a.x + (size_t)blockIdx.z * kC * plane;
    const P* scale = static_cast<const P*>(a.scale);

    // CustomLayerNorm of x over the region into Y0, in one pass from global
    // memory: kTpp threads per region pixel (one when the region has up to
    // 192 pixels, four when it has 64), each holding its kC / kTpp channels
    // in registers; two-pass unbiased variance over C, the mean not
    // subtracted; y0 rounded to bf16 and written 8 channels at a time. Rows
    // nr..mr of Y0 are zero. Y3 is zeroed (rows of pixels outside a ragged
    // tile stay zero).
    {
      constexpr int kTpp = kMr <= 64 ? 4 : 1;
      constexpr int kPix = kConsumers / kTpp;  // pixels in flight
      constexpr int kCpt = kC / kTpp;          // channels a thread holds
      static_assert(kMr <= kPix && kCpt % 8 == 0, "one pixel per thread group");
      float* red = Y1 + kC;                    // [kTpp][kPix] partial sums
      for (int c = tid; c < kC; c += kConsumers) Y1[c] = ld(scale[c]);  // f32 scale
      consumer_sync();
      const int p = tid % kPix, part = tid / kPix, cb = part * kCpt;
      const bool active = p < nr;
      const int i = p / rw;
      const bf16* src = x + (size_t)cb * plane + (size_t)(r0 + i) * W + c0 + (p - i * rw);
      __nv_bfloat162 v[kCpt / 2];
      float acc8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // 8 chains
#pragma unroll
      for (int k = 0; k < kCpt / 2; ++k) {
        const bf16 lo = active ? src[(2 * k) * plane] : __float2bfloat16(0.f);
        const bf16 hi = active ? src[(2 * k + 1) * plane] : __float2bfloat16(0.f);
        v[k] = __halves2bfloat162(lo, hi);
      }
#pragma unroll
      for (int k = 0; k < kCpt / 2; ++k) {
        const float2 f = __bfloat1622float2(v[k]);
        acc8[(2 * k) % 8] += f.x;
        acc8[(2 * k + 1) % 8] += f.y;
      }
      auto total = [&](float (&t)[8]) {  // the sum over this pixel's kTpp threads
        float sum = ((t[0] + t[1]) + (t[2] + t[3])) + ((t[4] + t[5]) + (t[6] + t[7]));
        if constexpr (kTpp > 1) {
          red[part * kPix + p] = sum;
          consumer_sync();
          sum = 0.f;
#pragma unroll
          for (int q = 0; q < kTpp; ++q) sum += red[q * kPix + p];
          consumer_sync();
        }
        return sum;
      };
      // With ns > 1 subnets of cs = C / ns channels (a multiple of 8, so an
      // 8-channel group lies in one), the statistics are taken again from
      // global memory, a run at a time in plain loops, so that nothing is
      // added to what the registers hold (v is the ns = 1 path's): each
      // thread writes its sum of every subnet's channels among its own to
      // red [s][part][pixel] (zero where it holds none), then the squared
      // deviations to red2; the first thread of a pixel writes each
      // subnet's 1 / sqrt(var + eps) to red [s][pixel], which the groups
      // of 8 channels read where they are written.
      const int ns = a.ns, cs = kC / ns;
      float inv = 1.f;
      if (ns == 1) {
        const float mean = total(acc8) / kC;
#pragma unroll
        for (int t = 0; t < 8; ++t) acc8[t] = 0.f;
#pragma unroll
        for (int k = 0; k < kCpt / 2; ++k) {
          const float2 f = __bfloat1622float2(v[k]);
          const float d0 = f.x - mean, d1 = f.y - mean;
          acc8[(2 * k) % 8] = fmaf(d0, d0, acc8[(2 * k) % 8]);
          acc8[(2 * k + 1) % 8] = fmaf(d1, d1, acc8[(2 * k + 1) % 8]);
        }
        inv = 1.f / sqrtf(total(acc8) / (kC - 1) + 1e-5f);
      } else {
        float* red2 = red + ns * kTpp * kPix;
        auto subnet_sum = [&](const float* r, int sub) {
          float sum = 0.f;
#pragma unroll
          for (int q = 0; q < kTpp; ++q) sum += r[(sub * kTpp + q) * kPix + p];
          return sum;
        };
        for (int pass = 0; pass < 2; ++pass) {
          float* out = pass ? red2 : red;
          for (int sub = 0; sub < ns; ++sub) {
            const int lo = max(sub * cs, cb) - cb, hi = min(sub * cs + cs, cb + kCpt) - cb;
            const float mean = pass ? subnet_sum(red, sub) / cs : 0.f;
            float sum = 0.f;
            if (active) {
#pragma unroll 4
              for (int c = lo; c < hi; ++c) {
                const float d = __bfloat162float(src[(size_t)c * plane]) - mean;
                sum = pass ? fmaf(d, d, sum) : sum + d;
              }
            }
            out[(sub * kTpp + part) * kPix + p] = sum;
          }
          consumer_sync();
        }
        if (part == 0)
          for (int sub = 0; sub < ns; ++sub)
            red[sub * kPix + p] = 1.f / sqrtf(subnet_sum(red2, sub) / (cs - 1) + 1e-5f);
        consumer_sync();
      }
      const float rcp_cs = 1.f / cs;
      if (p < kMr) {
#pragma unroll
        for (int g = 0; g < kCpt / 8; ++g) {
          const int c = cb + 8 * g;
          // the group's subnet c / cs by one multiply (exact: c < 2^22)
          if (ns > 1) inv = red[__float2int_rz((c + 0.5f) * rcp_cs) * kPix + p];
          uint4 o;
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float2 f = __bfloat1622float2(v[4 * g + t]);
            e[t] = active ? __floats2bfloat162_rn(f.x * inv * Y1[c + 2 * t],
                                                  f.y * inv * Y1[c + 2 * t + 1])
                          : __floats2bfloat162_rn(0.f, 0.f);
          }
          *reinterpret_cast<uint4*>(Y0 + (c >> 6) * kMr * 128 + sw128(p, c & 63)) = o;
        }
      }
      for (int idx = tid; idx < kMp * kHc * 2 / 16; idx += kConsumers)
        reinterpret_cast<uint4*>(Y3)[idx] = make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();
    consumer_sync();

    const int wg = role, wi = (tid % 128) / 32, lane = tid % 32;
    const int mtp = kSplit == 2 ? 0 : wg;         // this warpgroup's project M tile
    const int nbase = kSplit == 2 ? wg * kN : 0;  // and its first column
    const int npx = a.th * a.tw;
    const int tw_act = tj1 - tj0, th_act = ti1 - ti0;
    const uint32_t y0_u32 = smem_u32(Y0), y3_u32 = smem_u32(Y3);
    const uint32_t ring1 = smem_u32(sm + L.ring1), ring2 = smem_u32(sm + L.ring2);
    const int ch = tid % 32, pg = tid / 32;  // the taps: one hidden channel, column group
    const P* dwk = static_cast<const P*>(a.dwk);
    float accE[kNe / 2];
    float accP[kN64][32];
    float accQ[kN32 ? 16 : 1];  // the m64n32 piece

    const ExpandAt ex{y0_u32, ring1, (uint32_t)L.slot1, full1, empty1, Y1, wg, wi, lane};
    expand<kC, kNe>(ex, accE, 0);
    wgmma_wait<0>();
    store_expand<kNe>(ex, accE, 0);
    // this thread's tap weights (m and u channel) of chunk j, loaded a chunk ahead
    float km[9], ku[9];
    P kmn[9], kun[9];
    tap_weights(dwk, a.dw_st, a.dw_sh, ch, nh, kmn, kun);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      km[t] = ld(kmn[t]);
      ku[t] = ld(kun[t]);
    }
    for (int j = 0; j < nch; ++j) {
      const bool more = j + 1 < nch;
      if (more) tap_weights(dwk, a.dw_st, a.dw_sh, (j + 1) * kHc + ch, nh, kmn, kun);
      if (more) {  // the next chunk's expand, queued on the tensor cores first
        expand<kC, kNe>(ex, accE, j + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      if (j > 0) {  // the previous chunk's project is done: its slot and Y3 are free
#pragma unroll
        for (int q = 0; q < kN64; ++q) fence_regs(accP[q]);
        if constexpr (kN32) fence_regs(accQ);
        mbar_arrive(empty2 + (j - 1) % kStages);
      }
      consumer_sync();
      // taps and gate: one hidden channel a thread, sliding a 3x3 window down
      // columns pg, pg + 8, ... of the tile two rows at a time
      for (int tj = pg; tj < tw_act; tj += 8) {
        const int rj = tj0 + tj - c0;
        const float* cm[3];  // this column's three Y1 columns, at region row 0
#pragma unroll
        for (int db = 0; db < 3; ++db)
          cm[db] = Y1 + (min(max(rj - 1 + db, 0), rw - 1)) * kY1Ld + ch;
        const int ri0 = ti0 - r0, rs = rw * kY1Ld;  // rs: one region row of Y1
        float wm[4][3], wu[4][3];
#pragma unroll
        for (int dr = 0; dr < 2; ++dr) {
          const int ro = min(max(ri0 - 1 + dr, 0), rh - 1) * rs;
#pragma unroll
          for (int db = 0; db < 3; ++db) {
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
            for (int db = 0; db < 3; ++db) {
              wm[dr][db] = cm[db][ro];
              wu[dr][db] = cm[db][ro + 32];
            }
          }
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            float mr3[3], ur3[3];  // one partial sum per window row: short chains
#pragma unroll
            for (int dr = 0; dr < 3; ++dr) {
              mr3[dr] = wm[o + dr][0] * km[3 * dr];
              ur3[dr] = wu[o + dr][0] * ku[3 * dr];
#pragma unroll
              for (int db = 1; db < 3; ++db) {
                mr3[dr] = fmaf(wm[o + dr][db], km[3 * dr + db], mr3[dr]);
                ur3[dr] = fmaf(wu[o + dr][db], ku[3 * dr + db], ur3[dr]);
              }
            }
            const float m = (mr3[0] + mr3[1]) + mr3[2], u = (ur3[0] + ur3[1]) + ur3[2];
            if (o == 0 || ti + 1 < th_act)
              *reinterpret_cast<bf16*>(Y3 + sw64((ti + o) * a.tw + tj, ch)) =
                  __float2bfloat16(__frcp_rn(1.f + __expf(-m)) * m * u);
          }
#pragma unroll
          for (int db = 0; db < 3; ++db) {
            wm[0][db] = wm[2][db];
            wm[1][db] = wm[3][db];
            wu[0][db] = wu[2][db];
            wu[1][db] = wu[3][db];
          }
        }
      }
      fence_async_smem();
      consumer_sync();
      // project: acc[p][n] += sum_i Y3[p][i] w2^T[nbase + n][i]
      const uint32_t w2s = ring2 + (j % kStages) * L.slot2;
      mbar_wait(full2 + j % kStages, (j / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHc / 16; ++kk) {
        const uint64_t da = mdesc(y3_u32 + mtp * 64 * 64 + kk * 32, 512, kSw64);
        const int acc = j > 0 || kk > 0;
#pragma unroll
        for (int q = 0; q < kN64; ++q)
          wgmma_n64(accP[q], da, mdesc(w2s + (nbase + 64 * q) * 64 + kk * 32, 512, kSw64), acc);
        if constexpr (kN32)
          wgmma_n32(accQ, da, mdesc(w2s + (nbase + 64 * kN64) * 64 + kk * 32, 512, kSw64), acc);
      }
      wgmma_commit();
      if (more) {  // the next chunk's expand (committed before this project) is done
        wgmma_wait<1>();
        store_expand<kNe>(ex, accE, j + 1);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          km[t] = ld(kmn[t]);
          ku[t] = ld(kun[t]);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < kN64; ++q) fence_regs(accP[q]);
    if constexpr (kN32) fence_regs(accQ);

    // epilogue: out = s0 x + s1 acc over the tile's pixels
    const float s0 = ld(static_cast<const P*>(a.skip)[0]);
    const float s1 = ld(static_cast<const P*>(a.skip)[1]);
    bf16* out = a.out + (size_t)blockIdx.z * kC * plane;
    auto emit = [&](int i, int n, float v) {
      const int p = mtp * 64 + wi * 16 + lane / 4 + 8 * ((i % 4) / 2);
      const int ti = p / a.tw, tj = p - ti * a.tw;
      if (p < npx && ti < th_act && tj < tw_act) {
        const size_t o = (size_t)n * plane + (size_t)(ti0 + ti) * W + tj0 + tj;
        out[o] = __float2bfloat16(fmaf(s1, v, s0 * __bfloat162float(x[o])));
      }
    };
#pragma unroll
    for (int q = 0; q < kN64; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        emit(i, nbase + 64 * q + 8 * (i / 4) + 2 * (lane % 4) + (i % 2), accP[q][i]);
    if constexpr (kN32) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        emit(i, nbase + 64 * kN64 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2), accQ[i]);
    }
  }
}

char g_error[256] = "";

template <int kC, typename P>
int launch(const Args& a, const void* w1t, long long w1_pitch, const void* w2t,
           long long w2_pitch, int B, cudaStream_t stream) {
  CUtensorMap m1, m2;
  constexpr int kBoxRows = kC / ((kC + 255) / 256);
  if (!encode(&m1, w1t, 2 * a.nh, kC, w1_pitch, kHc, 64, CU_TENSOR_MAP_SWIZZLE_128B, "w1",
              g_error, sizeof g_error) ||
      !encode(&m2, w2t, kC, a.nh, w2_pitch, kBoxRows, kHc, CU_TENSOR_MAP_SWIZZLE_64B, "w2",
              g_error, sizeof g_error))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(kC, expand_rows(kC), kC > 192 ? 64 : 128).total;
  auto kern = gated_kernel<kC, P>;
  // the shared memory limit, raised once per device to the most a block has
  constexpr int kDevices = 64;
  static bool raised[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) raised[dev] = true;
  }
  const dim3 grid((a.W + a.tw - 1) / a.tw, (a.H + a.th - 1) / a.th, B);
  kern<<<grid, kThreads, smem, stream>>>(m1, m2, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int dispatch(int C, const Args& a, const void* w1t, long long w1p, const void* w2t,
             long long w2p, int B, cudaStream_t s) {
  switch (C) {
    case 96: return launch<96, P>(a, w1t, w1p, w2t, w2p, B, s);
    case 128: return launch<128, P>(a, w1t, w1p, w2t, w2p, B, s);
    case 192: return launch<192, P>(a, w1t, w1p, w2t, w2p, B, s);
    case 384: return launch<384, P>(a, w1t, w1p, w2t, w2p, B, s);
    default:
      snprintf(g_error, sizeof g_error, "C=%d: the kernel takes C in {96, 128, 192, 384}", C);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gated
}  // namespace irdu

// Why the last launch was refused before reaching CUDA ("" if it was not).
extern "C" const char* irdu_gated_block_error() { return irdu::gated::g_error; }

// x, out (B, C, H, W) bf16; w1t (2H, C) and w2t (C, H) bf16 with unit column
// stride, rows w1_pitch / w2_pitch elements apart (16-byte multiples, 16-byte
// aligned); scale (C,), dwk (9, 2H) by strides (tap, channel) and skip (2,)
// f32 (pdtype 0) or bf16 (pdtype 1); a th x tw tile (the plan of
// gated_block.plan_gated_tiles); ns the norm's subnets, runs of C / ns
// channels, a multiple of 8 (ns <= 8 at C = 384, where the partial sums
// must fit Y1).
extern "C" int irdu_gated_block(const void* x, void* out, const void* scale, const void* w1t,
                                const void* dwk, const void* w2t, const void* skip, int B,
                                int C, int H, int W, int nh, long long w1_pitch,
                                long long w2_pitch, long long dw_st, long long dw_sh, int th,
                                int tw, int pdtype, int ns, void* stream) {
  using namespace irdu::gated;
  g_error[0] = '\0';
  const int region = std::min(th + 2, H) * std::min(tw + 2, W);
  const bool aligned = reinterpret_cast<uintptr_t>(w1t) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w2t) % 16 == 0 && w1_pitch % 8 == 0 &&
                       w2_pitch % 8 == 0 && w1_pitch >= C && w2_pitch >= nh;
  const int mr = expand_rows(C), mp = C > 192 ? 64 : 128;
  if (B < 1 || H < 1 || W < 1 || nh < kHc || nh % kHc || th < 1 || tw < 1 || th * tw > mp ||
      region > mr || !aligned ||
      (pdtype != irdu::kFloat32 && pdtype != irdu::kBFloat16) ||
      layout(C, mr, mp).total > kSmemLimit || ns < 1 || C % ns || (C / ns) % 8 ||
      C + 2 * ns * kConsumers > mr * kY1Ld) {
    snprintf(g_error, sizeof g_error,
             "plan or operands not taken: C=%d H=%d th=%d tw=%d nsubnets=%d", C, nh, th, tw, ns);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), scale,
               dwk, skip, dw_st, dw_sh, H, W, nh, th, tw, ns};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pdtype == irdu::kFloat32
             ? dispatch<float>(C, a, w1t, w1_pitch, w2t, w2_pitch, B, s)
             : dispatch<__nv_bfloat16>(C, a, w1t, w1_pitch, w2t, w2_pitch, B, s);
}
