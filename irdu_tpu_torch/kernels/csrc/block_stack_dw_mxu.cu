// K3's dw_mxu variant in bf16 on Hopper: K <= 4 consecutive
// LocalNonLinearBlocks of the flagship, CHW, with the 1x1 expand folded into
// the 3x3 depthwise taps and the nine tap products run on the tensor cores.
// Replaces the dw_mxu branch of irdu_tpu/ops/pallas/block_stack.py:
// fused_block_stack (_kernel, dw_mxu=True; the tap matrices m9 packed at
// trace time). The block, its rounding points and the bound are set out in
// irdu_tpu_torch/ops/block_stack.py. (The served K3 is block_stack_wgmma.cu:
// the expand on wgmma and the taps on the CUDA cores.)
//
// The depthwise tap scale is per hidden channel, so
//   z_h(p) = sum_t dwk_h(t) (W1^T y0)_h(p + t) = sum_t (m9[t] y0(p + t))_h,
//   m9[t] = w1^T (.) dwk[t] (2H x C, rounded to bf16 by the wrapper):
// nine products of the tile's y0 shifted by each tap against m9[t], in
// place of one expand and 9 * 2H CUDA-core FMAs a pixel. Per pixel and
// block that is 9 * 2 * C * 2H tensor-core operations (9x the expand's) and
// only the gate (6 * H), the norm and the skip on the CUDA cores.
//
// A shifted tile is not a canonical wgmma operand in shared memory (its rows
// are not 8-row groups at one pitch once the shift crosses a tile row), so
// the pixels are wgmma's M and y0 the A operand from registers: each lane
// gives ldmatrix the address of its pixel's shifted row of Y0 (the region's
// normalized input, one row a pixel, clamped to the region: the replicate
// pad at an image edge), and m9[t] is B in shared memory. Per warpgroup and
// chunk of hc = 32 m-channels and their 32 u-channels: D (64 pixels x 64
// hidden) = sum over the 9 taps and C / 16 k-steps of m64n64k16 (the A
// fragments of two taps in flight), then the gate in registers (m and u of a
// hidden channel are columns c and c + 32 of D: the same thread), y3 (bf16)
// into Y3, and the project on wgmma (m64nCk16 over hc) into a register
// accumulator held across the chunks, as in block_stack_wgmma.cu.
//
// One persistent cooperative launch, K phases (one block each) separated by
// grid barriers; between blocks the f32 activation goes through the
// wrapper's channels-last scratch (ping-pong), as in block_stack_wgmma.cu, so
// each block needs a 1-pixel halo. 256 threads, two warpgroups of 64 tile
// pixels each (a tile th x tw <= 128 pixels, its region <= 192, from
// block_stack.plan_stack_tiles); thread 0 issues the TMA loads: per (tile,
// chunk) the chunk's nine m9 taps (72 KB) into one of two slots, a load
// ahead, and per phase block k's w2^T. Shared memory, each part 1024-byte
// aligned:
//   Y0   bf16 (192, 64)        the region's normalized input, 128-byte swizzle
//   M9   2 x 9 x 8 KB          a chunk's taps: 64 rows (m, then u) x 64
//                              channels, 128-byte swizzle; channels C..63 zero
//   W2   nch x C x 64 bytes    w2^T chunks: C rows x 32 hidden, 64-byte swizzle
//   Y3   bf16 (128, 32)        a chunk's gate output, 64-byte swizzle
//   the block's C norm scales (f32) and 3 mbarriers (two M9 slots, W2)
// The epilogue s0 x + s1 acc reads the block's input x again from global
// memory (L2).

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>

#include "hopper.cuh"

namespace irdu {
namespace dwmxu {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kHc = 32;                        // hidden channels per chunk
constexpr int kMaxChunks = 4;                  // H <= 128
constexpr int kThreads = 256;                  // two warpgroups
constexpr int kMr = 192;                       // Y0 rows: the region's pixels, padded
constexpr int kMp = 128;                       // tile pixels: 64 per warpgroup
constexpr int kTaps = 9;
constexpr int kTapBytes = 64 * 128;            // one tap of a chunk: 64 hidden x 64 channels
constexpr int kSlotBytes = kTaps * kTapBytes;  // a chunk's nine taps

// Shared-memory layout; must match irdu_tpu_torch/ops/block_stack.py:dw_mxu_smem_bytes.
struct Layout {
  size_t y0, m9, w2, slot2, y3, scale, bars, total;
};

__host__ __device__ inline Layout layout(int C, int nch) {
  Layout L;
  L.y0 = 0;
  L.m9 = align1k((size_t)kMr * 128);
  L.w2 = L.m9 + 2 * (size_t)kSlotBytes;
  L.slot2 = align1k((size_t)C * kHc * 2);
  L.y3 = L.w2 + nch * L.slot2;
  L.scale = L.y3 + (size_t)kMp * kHc * 2;
  L.bars = L.scale + 64 * sizeof(float);
  L.total = L.bars + 3 * 8 + 1024;  // + slack to align the base
  return L;
}

struct Args {
  const bf16* x;       // (B, C, H, W), phase 0's input
  bf16* out;           // (B, C, H, W), the last phase's output
  float* scratch[2];   // (B, H, W, C) f32 each, phases 0..K-2 write S[k & 1]
  const float* scale;  // (K, C)
  const float* skip;   // (K, 2)
  int B, H, W, K, nh, th, tw, tiles_x, tiles_y;
};

// Load n of this CTA's sequence (block n / per_block, chunk n % nch: every
// tile of a phase takes the same nch chunks) into M9 slot n & 1.
__device__ __forceinline__ void issue_m9(int n, int per_block, int nch, int nh,
                                         const CUtensorMap* map, unsigned char* m9,
                                         uint64_t* full) {
  const int k = n / per_block, j = n % nch;
  uint64_t* bar = full + (n & 1);
  unsigned char* slot = m9 + (size_t)(n & 1) * kSlotBytes;
  mbar_expect_tx(bar, kSlotBytes);
#pragma unroll 1
  for (int t = 0; t < kTaps; ++t) {
    const int row = (k * kTaps + t) * 2 * nh + j * kHc;
    tma_load(slot + t * kTapBytes, map, 0, row, bar);
    tma_load(slot + t * kTapBytes + 4096, map, 0, row + nh, bar);
  }
}

// One output tile of block k. `used` counts the M9 loads this CTA consumed.
template <int kC>
__device__ __forceinline__ void tile(const Args& a, int k, int t, unsigned char* sm,
                                     const Layout& L, uint64_t* full, const CUtensorMap* m9map,
                                     int& used, int loads, int per_block) {
  unsigned char* Y0 = sm + L.y0;
  unsigned char* Y3 = sm + L.y3;
  float* S = reinterpret_cast<float*>(sm + L.scale);
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
  const int th_act = ti1 - ti0, tw_act = tj1 - tj0, npx = a.th * a.tw;
  const size_t plane = (size_t)H * W, boff = (size_t)b * kC * plane;
  const bool first = k == 0, last = k == a.K - 1;
  const bf16* xb = a.x + boff;                      // phase 0's input
  const float* xf = a.scratch[(k + 1) & 1] + boff;  // later phases' (S[(k - 1) & 1])

  __syncthreads();  // the previous tile is done with Y0, Y3 and S
  for (int c = tid; c < kC; c += kThreads) S[c] = a.scale[k * kC + c];
  __syncthreads();
  // CustomLayerNorm of the region into Y0, one thread per pixel holding its
  // kC channels in registers: two-pass variance, ddof 1, the mean not
  // subtracted; rows nr..kMr zero
  if (tid < kMr) {
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
        const float4 f = active ? __ldcg(q + c / 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[c] = f.x, v[c + 1] = f.y, v[c + 2] = f.z, v[c + 3] = f.w;
      }
    }
    float acc8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // 8 chains
#pragma unroll
    for (int c = 0; c < kC; ++c) acc8[c % 8] += v[c];
    const float mean = (((acc8[0] + acc8[1]) + (acc8[2] + acc8[3])) +
                        ((acc8[4] + acc8[5]) + (acc8[6] + acc8[7]))) / kC;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc8[q] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float d = v[c] - mean;
      acc8[c % 8] = fmaf(d, d, acc8[c % 8]);
    }
    const float var = ((acc8[0] + acc8[1]) + (acc8[2] + acc8[3])) +
                      ((acc8[4] + acc8[5]) + (acc8[6] + acc8[7]));
    const float inv = 1.f / sqrtf(var / (kC - 1) + 1e-5f);
#pragma unroll
    for (int g = 0; g < kC / 8; ++g) {
      uint4 o;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 8 * g + 2 * q;
        e[q] = active ? __floats2bfloat162_rn(v[c] * inv * S[c], v[c + 1] * inv * S[c + 1])
                      : __floats2bfloat162_rn(0.f, 0.f);
      }
      *reinterpret_cast<uint4*>(Y0 + sw128(p, 8 * g)) = o;
    }
  }
  __syncthreads();

  // This lane's A row: tile pixel pl (a pixel past the tile reads one of
  // it; its results are not stored), and its Y0 rows for the three row and
  // column offsets, clamped to the region.
  const int mi = lane / 8, kofs = 8 * (mi >> 1);
  const int pl = wg * 64 + wi * 16 + (lane % 8) + 8 * (mi & 1);
  const int li = min(pl / a.tw, th_act - 1), lj = min(pl % a.tw, tw_act - 1);
  int rrow[3], rcol[3];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    rrow[o] = min(max(ti0 + li + o - 1 - r0, 0), rh - 1) * rw;
    rcol[o] = min(max(tj0 + lj + o - 1 - c0, 0), rw - 1);
  }
  const uint32_t y0_u32 = smem_u32(Y0), y3_u32 = smem_u32(Y3);
  const uint32_t m9_u32 = smem_u32(sm + L.m9), w2_u32 = smem_u32(sm + L.w2);
  float accP[kC / 2];
  float d[32];
  uint32_t af[2][kC / 16][4];

  for (int j = 0; j < nch; ++j) {
    const int slot = used & 1;
    mbar_wait(full + slot, (used >> 1) & 1);
    const uint32_t m9s = m9_u32 + slot * kSlotBytes;
    // D (64 pixels x 64 hidden) = sum_t y0(p + t) m9[t]^T; the fragments of
    // tap t are loaded while tap t - 1's products run
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int px = rrow[tap / 3] + rcol[tap % 3];
#pragma unroll
      for (int ks = 0; ks < kC / 16; ++ks)
        ldsm_x4(af[tap & 1][ks], y0_u32 + sw128(px, ks * 16 + kofs));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kC / 16; ++ks)
        wgmma_rs_n64(d, af[tap & 1][ks], mdesc(m9s + tap * kTapBytes + ks * 32, 1024, kSw128),
                     tap > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // tap t - 1's products are done: its fragments are free
    }
    wgmma_wait<0>();
    fence_regs(d);
    __syncthreads();  // both warpgroups are done with the slot
    if (tid == 0 && used + 2 < loads)
      issue_m9(used + 2, per_block, nch, nh, m9map, sm + L.m9, full);
    ++used;
    // gate: y3 = sigmoid(m) m u, m and u of hidden channel c in columns c and
    // c + 32 of D (registers i and i + 16), two adjacent channels at a time;
    // this warpgroup's rows of Y3 (the previous chunk's project, their only
    // reader, was waited for above)
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int row = wg * 64 + wi * 16 + lane / 4 + 8 * ((i % 4) / 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const float m0 = d[i], m1 = d[i + 1], u0 = d[i + 16], u1 = d[i + 17];
      *reinterpret_cast<__nv_bfloat162*>(Y3 + sw64(row, col)) =
          __floats2bfloat162_rn(__frcp_rn(1.f + __expf(-m0)) * m0 * u0,
                                __frcp_rn(1.f + __expf(-m1)) * m1 * u1);
    }
    fence_async_smem();
    __syncthreads();
    if (j == 0) mbar_wait(full + 2, k & 1);  // block k's w2^T
    // project: acc[p][n] += sum_i Y3[p][i] w2^T[n][i]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHc / 16; ++kk)
      wgmma_project<kC>(accP, mdesc(y3_u32 + wg * 64 * 64 + kk * 32, 512, kSw64),
                        mdesc(w2_u32 + j * L.slot2 + kk * 32, 512, kSw64), j > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(accP);

  // epilogue: s0 x + s1 acc over the tile's pixels, x this block's input;
  // registers i and i + 1 (i even) hold channels n and n + 1 of one pixel
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
      float x0, x1;
      if (first) {
        x0 = __bfloat162float(xb[n * plane + px]);
        x1 = __bfloat162float(xb[(n + 1) * plane + px]);
      } else {
        const float2 xv = __ldcg(reinterpret_cast<const float2*>(xf + px * kC + n));
        x0 = xv.x, x1 = xv.y;
      }
      const float y0 = fmaf(s1, accP[i], s0 * x0), y1 = fmaf(s1, accP[i + 1], s0 * x1);
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
    dw_mxu_kernel(const __grid_constant__ CUtensorMap m9map,
                  const __grid_constant__ CUtensorMap w2map, Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* sm = smem_raw + pad;
  const int nch = a.nh / kHc;
  const Layout L = layout(kC, nch);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);  // M9 slots 0, 1; W2
  const int tid = threadIdx.x;
  const int tiles = a.B * a.tiles_y * a.tiles_x;
  const int mine = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;  // tiles a phase
  const int per_block = mine * nch, loads = a.K * per_block;
  if (tid == 0) {
    for (int q = 0; q < 3; ++q) mbar_init(full + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    issue_m9(0, per_block, nch, a.nh, &m9map, sm + L.m9, full);
    if (loads > 1) issue_m9(1, per_block, nch, a.nh, &m9map, sm + L.m9, full);
  }
  cg::grid_group grid = cg::this_grid();
  int used = 0;
  for (int k = 0; k < a.K; ++k) {
    if (tid == 0) {  // block k's w2^T (every project of block k - 1 is done)
      mbar_expect_tx(full + 2, nch * kC * kHc * 2);
      for (int j = 0; j < nch; ++j)
        tma_load(sm + L.w2 + j * L.slot2, &w2map, j * kHc, k * kC, full + 2);
    }
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      tile<kC>(a, k, t, sm, L, full, &m9map, used, loads, per_block);
    if (k + 1 < a.K) grid.sync();
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
  auto kern = dw_mxu_kernel<kC>;
  const size_t most = layout(kC, kMaxChunks).total;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads, most);
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
int launch(Args a, const void* m9, const void* w2t, cudaStream_t stream) {
  CUtensorMap mm, m2;
  if (!encode(&mm, m9, a.K * kTaps * 2 * a.nh, kC, kC, kHc, 64, CU_TENSOR_MAP_SWIZZLE_128B,
              "m9", g_error, sizeof g_error) ||
      !encode(&m2, w2t, a.K * kC, a.nh, a.nh, kC, kHc, CU_TENSOR_MAP_SWIZZLE_64B, "w2",
              g_error, sizeof g_error))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy<kC>(&per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int tiles = a.B * a.tiles_y * a.tiles_x;
  const int grid = std::min(tiles, per_sm * sms);
  void* params[] = {&mm, &m2, &a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dw_mxu_kernel<kC>), dim3(grid), dim3(kThreads), params,
      layout(kC, a.nh / kHc).total, stream));
}

}  // namespace dwmxu
}  // namespace irdu

// Why the last launch was refused before reaching CUDA ("" if it was not).
extern "C" const char* irdu_block_stack_dw_mxu_error() { return irdu::dwmxu::g_error; }

// Shared memory of one CTA at C and hidden width nh (the planner's check).
extern "C" long long irdu_block_stack_dw_mxu_smem(int C, int nh) {
  return static_cast<long long>(irdu::dwmxu::layout(C, nh / irdu::dwmxu::kHc).total);
}

// x, out (B, C, H, W) bf16; scratch 2 (K >= 3), 1 (K = 2) or 0 buffers of
// B * H * W * C f32; scale (K, C) and skip (K, 2) f32; m9 (K, 9, 2nh, C) and
// w2t (K, C, nh) bf16, all contiguous; a th x tw tile (the plan of
// block_stack.plan_stack_tiles).
extern "C" int irdu_block_stack_dw_mxu(const void* x, void* out, void* scratch,
                                       const void* scale, const void* m9, const void* w2t,
                                       const void* skip, int B, int C, int H, int W, int K,
                                       int nh, int th, int tw, void* stream) {
  using namespace irdu::dwmxu;
  g_error[0] = '\0';
  const int region = std::min(th + 2, H) * std::min(tw + 2, W);
  const bool aligned = reinterpret_cast<uintptr_t>(m9) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w2t) % 16 == 0;
  if (B < 1 || H < 1 || W < 1 || K < 1 || K > 4 || nh < kHc || nh % kHc ||
      nh > kMaxChunks * kHc || th < 1 || tw < 1 || th * tw > kMp || region > kMr || !aligned ||
      (K > 1 && scratch == nullptr)) {
    snprintf(g_error, sizeof g_error, "plan or operands not taken: C=%d H=%d K=%d th=%d tw=%d",
             C, nh, K, th, tw);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* s = static_cast<float*>(scratch);
  const size_t n = (size_t)B * C * H * W;
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
         {s, K > 2 ? s + n : s}, static_cast<const float*>(scale),
         static_cast<const float*>(skip), B, H, W, K, nh, th, tw, (W + tw - 1) / tw,
         (H + th - 1) / th};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16>(a, m9, w2t, st);
    case 32: return launch<32>(a, m9, w2t, st);
    case 48: return launch<48>(a, m9, w2t, st);
    case 64: return launch<64>(a, m9, w2t, st);
    default:
      snprintf(g_error, sizeof g_error, "C=%d: the kernel takes C in {16, 32, 48, 64}", C);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
