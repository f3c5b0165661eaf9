// K3 and K4: K consecutive LocalNonLinearBlocks of the flagship, CHW, in one
// pass. Replaces irdu_tpu/ops/pallas/block_stack.py:fused_block_stack (K <= 4)
// and irdu_tpu/ops/pallas/gated_block.py:fused_gated_block (K = 1) for the
// calls the wgmma kernels do not take: f32, and K3 at lite's C = 24 (the
// rule: ops/block_stack.py:stack_route). The block, its rounding points, the
// bound and the design are set out in irdu_tpu_torch/ops/gated_block.py.
//
// One CTA per output tile. Shared memory holds, for the tile plus a K-pixel
// halo clipped to the image (the "region", nr pixels, padded to nrp, a
// multiple of 16; the f32 rows have stride ldx >= nrp), with the channels
// padded to Cp, C rounded up to 16 (the products' depth and row tiles):
//   X   f32 (Cp, nrp)        the activation, carried in f32 across the K blocks
//   Y1  f32 (2hc, nrp)       one hidden chunk of the expand: hc m- and hc u-rows
//   Dk  f32 (9, 2hc)         the chunk's depthwise taps
//   Y0  T   (nrp, Cp + pad)  the normalized input, channels contiguous
//   Y3  T   (nrp, hc + pad)  the gate output of the chunk
//   W1c T   (2hc, Cp + pad)  the chunk's expand weights
//   W2c T   (Cp, hc + pad)   the chunk's project weights
// The padded channels (C = 24 of the lite model, C ≡ 8 mod 16) are zero in
// X, Y0, W1c and W2c, so they add nothing to either product; the norm runs
// over the true C and the tile writes only the true C back.
// With T = bf16 the two 1x1 products are mma.sync m16n8k16 (bf16 in, f32
// accumulate): A the weights (rows x channels), B the activations (pixels x
// channels, the mma's column-major B), so both operands load as 32-bit pairs;
// pad = 8 keeps those loads free of bank conflicts. With T = f32 they are FMAs
// on the CUDA cores (pad = 1).
//
// A tap reads the region through a clamp to the region's bounds: at an image
// edge that is the replicate pad of the block's own input; at an interior
// edge it is wrong, and the error moves one pixel inward per block, never
// reaching the tile after K blocks. So each block computes only the rows and
// columns it can get right, one pixel fewer per block on interior sides.
// Per hidden chunk the next chunk's weights arrive by cp.async during the
// taps, so a chunk takes three barriers.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace irdu {
namespace blocks {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 4;  // rows one thread slides the depthwise window over
constexpr size_t kSmemLimit = 232448;

template <typename T>
__host__ __device__ constexpr int pad_of() { return std::is_same<T, float>::value ? 1 : 8; }

__host__ __device__ inline size_t seg(size_t n) { return (n + 15) / 16 * 16; }

// Row stride of the f32 (rows, pixels) arrays: nrp padded to 8 mod 32 words,
// so that the 8-byte stores of an mma result hit no bank twice per phase.
__host__ __device__ inline int ldx_of(int nrp) { return nrp + ((8 - nrp % 32) + 32) % 32; }

__host__ __device__ inline int cpad_of(int C) { return (C + 15) / 16 * 16; }

// Must match irdu_tpu_torch/ops/gated_block.py:smem_bytes (C there is Cp here).
template <typename T>
inline size_t smem_bytes(int C, int hc, int nrp) {
  const size_t e = sizeof(T), pad = pad_of<T>();
  const size_t ldx = ldx_of(nrp);
  return seg(4ull * C * ldx) + seg(4ull * 2 * hc * ldx) + seg(4ull * 9 * 2 * hc) +
         seg(e * nrp * (C + pad)) + seg(e * nrp * (hc + pad)) + seg(e * 2 * hc * (C + pad)) +
         seg(e * C * (hc + pad));
}

struct Args {
  const void* x;
  void* out;
  const void* scale;  // (K, C)
  const void* w1;     // (K, C, 2H) by strides
  const void* dwk;    // (K, 9, 2H) by strides
  const void* w2;     // (K, H, C) by strides
  const void* skip;   // (K, 2)
  int C, H, W, K, nh, th, tw, hc, nrp, Cp;  // Cp: C padded to 16
  long long w1_sk, w1_sc, w1_sh, dw_sk, dw_st, dw_sh, w2_sk, w2_sh, w2_sc;
  int ns;  // subnets: the norm runs over each run of C / ns channels
};

// n / d for 0 <= n < 2^22 and d > 0, by one f32 multiply with inv = 1 / d:
// the f32 error of (n + 0.5) * inv stays below 0.5 / d, so truncation gives
// the exact quotient (an integer division takes ~20
// instructions, and the loops below take one per element).
__device__ __forceinline__ int div_small(int n, float inv) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D[m][n] = sum_k A[m][k] B[n][k] for m < M (a multiple of 16) and n in
// [n_lo, n_hi) (multiples of 16), Kd a multiple of 16; epi(m, n, v0, v1)
// receives the pairs (m, n), (m, n + 1), every element once. In bf16 a warp
// takes a 16-row tile by two 8-column tiles, two independent mma chains.
template <typename Epi>
__device__ __forceinline__ void gemm(const __nv_bfloat16* A, int lda,
                                     const __nv_bfloat16* B, int ldb, int M, int n_lo,
                                     int n_hi, int Kd, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntn = (n_hi - n_lo) / 16, items = (M / 16) * ntn;
  const float inv = 1.f / ntn;
  for (int it = warp; it < items; it += kWarps) {
    const int mt = div_small(it, inv);
    const int m0 = mt * 16, n0 = n_lo + (it - mt * ntn) * 16;
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* a = A + (m0 + g) * lda + 2 * t;
    const __nv_bfloat16* b0 = B + (n0 + g) * ldb + 2 * t;
    const __nv_bfloat16* b1 = b0 + 8 * ldb;
    for (int k = 0; k < Kd; k += 16) {
      const uint32_t af[4] = {ld32(a + k), ld32(a + 8 * lda + k), ld32(a + k + 8),
                              ld32(a + 8 * lda + k + 8)};
      mma_bf16(d0, af, ld32(b0 + k), ld32(b0 + k + 8));
      mma_bf16(d1, af, ld32(b1 + k), ld32(b1 + k + 8));
    }
    epi(m0 + g, n0 + 2 * t, d0[0], d0[1]);
    epi(m0 + g + 8, n0 + 2 * t, d0[2], d0[3]);
    epi(m0 + g, n0 + 8 + 2 * t, d1[0], d1[1]);
    epi(m0 + g + 8, n0 + 8 + 2 * t, d1[2], d1[3]);
  }
}

template <typename Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, const float* B, int ldb,
                                     int M, int n_lo, int n_hi, int Kd, Epi epi) {
  const int N2 = (n_hi - n_lo) / 2;
  for (int idx = threadIdx.x; idx < M * N2; idx += kThreads) {
    const int m = idx / N2, n = n_lo + 2 * (idx - m * N2);
    float acc0 = 0.f, acc1 = 0.f;
    for (int k = 0; k < Kd; ++k) {
      const float w = A[m * lda + k];
      acc0 = fmaf(w, B[n * ldb + k], acc0);
      acc1 = fmaf(w, B[(n + 1) * ldb + k], acc1);
    }
    epi(m, n, acc0, acc1);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// The hidden channel of row r of a chunk starting at j0: the m half
// (r < hc) is j0 + r, the u half nh + j0 + r - hc.
__device__ __forceinline__ int hidden_of(int r, int j0, int hc, int nh) {
  return r < hc ? j0 + r : nh + j0 + r - hc;
}

// W1c (2hc, C): the chunk's expand weights (columns C..Cp stay zero). In bf16
// asynchronous 16-byte copies (the host guarantees unit stride along C); in
// f32 plain copies.
template <typename T>
__device__ __forceinline__ void copy_w1(const Args& a, int k, int j0, T* W1c) {
  const int C = a.C, hc = a.hc, ldc = a.Cp + pad_of<T>();
  const T* w1 = static_cast<const T*>(a.w1) + k * a.w1_sk;
  if constexpr (std::is_same<T, float>::value) {
    for (int idx = threadIdx.x; idx < 2 * hc * C; idx += kThreads) {
      const int r = idx / C, c = idx - r * C;
      W1c[r * ldc + c] = w1[c * a.w1_sc + hidden_of(r, j0, hc, a.nh) * a.w1_sh];
    }
  } else {
    const int cv = C / 8;
    const float inv = 1.f / cv;
    for (int idx = threadIdx.x; idx < 2 * hc * cv; idx += kThreads) {
      const int r = div_small(idx, inv), c8 = (idx - r * cv) * 8;
      cp_async16(W1c + r * ldc + c8, w1 + hidden_of(r, j0, hc, a.nh) * a.w1_sh + c8);
    }
  }
}

// W2c (C, hc): the chunk's project weights (bf16: unit stride along H; rows
// C..Cp stay zero).
template <typename T>
__device__ __forceinline__ void copy_w2(const Args& a, int k, int j0, T* W2c) {
  const int C = a.C, hc = a.hc, ldh = hc + pad_of<T>();
  const T* w2 = static_cast<const T*>(a.w2) + k * a.w2_sk;
  if constexpr (std::is_same<T, float>::value) {
    for (int idx = threadIdx.x; idx < C * hc; idx += kThreads) {
      const int c = idx / hc, i = idx - c * hc;
      W2c[c * ldh + i] = w2[(j0 + i) * a.w2_sh + c * a.w2_sc];
    }
  } else {
    const int iv = hc / 8;
    const float inv = 1.f / iv;
    for (int idx = threadIdx.x; idx < C * iv; idx += kThreads) {
      const int c = div_small(idx, inv), i8 = (idx - c * iv) * 8;
      cp_async16(W2c + c * ldh + i8, w2 + c * a.w2_sc + j0 + i8);
    }
  }
}

// The chunk's 9 x 2hc depthwise taps, at most two per thread, into registers;
// store_dk puts them into Dk (9, 2hc).
template <typename P>
__device__ __forceinline__ void load_dk(const Args& a, int k, int j0, float (&d)[2]) {
  const P* dwk = static_cast<const P*>(a.dwk) + k * a.dw_sk;
  const int n2 = 2 * a.hc;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int idx = threadIdx.x + s * kThreads;
    if (idx < 9 * n2) {
      const int t = idx / n2, r = idx - t * n2;
      d[s] = ld(dwk[t * a.dw_st + hidden_of(r, j0, a.hc, a.nh) * a.dw_sh]);
    }
  }
}

__device__ __forceinline__ void store_dk(float* Dk, int hc, const float (&d)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int idx = threadIdx.x + s * kThreads;
    if (idx < 18 * hc) Dk[idx] = d[s];
  }
}

__device__ __forceinline__ void st2(float* p, float v0, float v1) {
  p[0] = v0;
  p[1] = v1;
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, 1) block_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int pad = pad_of<T>();
  const int C = a.C, Cp = a.Cp, hc = a.hc, nrp = a.nrp, ldx = ldx_of(nrp);
  const int ldc = Cp + pad, ldh = hc + pad;
  unsigned char* s = smem;
  float* X = reinterpret_cast<float*>(s);
  s += seg(4ull * Cp * ldx);
  float* Y1 = reinterpret_cast<float*>(s);
  s += seg(4ull * 2 * hc * ldx);
  float* Dk = reinterpret_cast<float*>(s);
  s += seg(4ull * 9 * 2 * hc);
  T* Y0 = reinterpret_cast<T*>(s);
  s += seg(sizeof(T) * nrp * ldc);
  T* Y3 = reinterpret_cast<T*>(s);
  s += seg(sizeof(T) * nrp * ldh);
  T* W1c = reinterpret_cast<T*>(s);
  s += seg(sizeof(T) * 2 * hc * ldc);
  T* W2c = reinterpret_cast<T*>(s);

  // tile [ti0, ti1) x [tj0, tj1); region [r0, r1) x [c0, c1)
  const int ti0 = blockIdx.y * a.th, tj0 = blockIdx.x * a.tw;
  const int ti1 = min(ti0 + a.th, a.H), tj1 = min(tj0 + a.tw, a.W);
  const int r0 = max(ti0 - a.K, 0), r1 = min(ti1 + a.K, a.H);
  const int c0 = max(tj0 - a.K, 0), c1 = min(tj1 + a.K, a.W);
  const int rh = r1 - r0, rw = c1 - c0, nr = rh * rw;
  // Where the region ends inside the image (top, bot, left, right), what a
  // block can get right shrinks by one pixel per block: block k reads rows
  // [top*k, rh - bot*k) and writes rows [top*(k+1), rh - bot*(k+1)) and the
  // columns likewise; the last block writes the tile.
  const int top = r0 > 0, bot = r1 < a.H, left = c0 > 0, right = c1 < a.W;
  const size_t plane = (size_t)a.H * a.W;
  const size_t boff = (size_t)blockIdx.z * C * plane;
  const T* x = static_cast<const T*>(a.x) + boff;
  const P* scale = static_cast<const P*>(a.scale);
  const P* skip = static_cast<const P*>(a.skip);

  const float inv_nrp = 1.f / nrp, inv_rw = 1.f / rw;
  for (int idx = threadIdx.x; idx < Cp * nrp; idx += kThreads) {
    const int c = div_small(idx, inv_nrp), p = idx - c * nrp;
    float v = 0.f;
    if (p < nr && c < C) {
      const int i = div_small(p, inv_rw), j = p - i * rw;
      v = ld(x[c * plane + (size_t)(r0 + i) * a.W + c0 + j]);
    }
    X[c * ldx + p] = v;
  }
  for (int idx = threadIdx.x; idx < nrp * ldh; idx += kThreads) st(Y3 + idx, 0.f);
  for (int idx = nr * ldc + threadIdx.x; idx < nrp * ldc; idx += kThreads) st(Y0 + idx, 0.f);
  if (Cp > C) {  // the padded channels: Y0's and W1c's columns, W2c's rows
    const int cz = Cp - C;
    for (int idx = threadIdx.x; idx < nr * cz; idx += kThreads) {
      const int p = idx / cz;
      st(Y0 + p * ldc + C + idx - p * cz, 0.f);
    }
    for (int idx = threadIdx.x; idx < 2 * hc * cz; idx += kThreads) {
      const int r = idx / cz;
      st(W1c + r * ldc + C + idx - r * cz, 0.f);
    }
    for (int idx = threadIdx.x; idx < cz * ldh; idx += kThreads) st(W2c + C * ldh + idx, 0.f);
  }
  float dk[2];
  copy_w1<T>(a, 0, 0, W1c);
  load_dk<P>(a, 0, 0, dk);
  cp_async_wait_all();

  for (int k = 0; k < a.K; ++k) {
    const float s0 = ld(skip[2 * k]), s1 = ld(skip[2 * k + 1]);
    const int in_lo = top * k * rw, in_hi = (rh - bot * k) * rw;
    const int out_lo = top * (k + 1) * rw, out_hi = (rh - bot * (k + 1)) * rw;
    __syncthreads();
    // CustomLayerNorm over each subnet's cs = C / ns channels (one run when
    // ns = 1), two-pass unbiased variance; then X <- s0 * X, so the project
    // below can accumulate s1 * y4 into X. cs is even, so a pair of
    // channels never straddles two subnets.
    const int cs = C / a.ns;
    for (int p = in_lo + threadIdx.x; p < in_hi; p += kThreads) {
      T* y0 = Y0 + p * ldc;
      for (int lo = 0; lo < C; lo += cs) {
        float mean = 0.f;
        for (int c = lo; c < lo + cs; ++c) mean += X[c * ldx + p];
        mean /= cs;
        float var = 0.f;
        for (int c = lo; c < lo + cs; ++c) {
          const float d = X[c * ldx + p] - mean;
          var = fmaf(d, d, var);
        }
        const float inv = 1.f / sqrtf(var / (cs - 1) + 1e-5f);
        for (int c = lo; c < lo + cs; c += 2) {
          const float x0 = X[c * ldx + p], x1 = X[(c + 1) * ldx + p];
          st2(y0 + c, x0 * inv * ld(scale[k * C + c]), x1 * inv * ld(scale[k * C + c + 1]));
          X[c * ldx + p] = s0 * x0;
          X[(c + 1) * ldx + p] = s0 * x1;
        }
      }
    }
    for (int j0 = 0; j0 < a.nh; j0 += hc) {
      const bool last_chunk = j0 + hc == a.nh;
      const int kn = last_chunk ? k + 1 : k, jn = last_chunk ? 0 : j0 + hc;
      // the norm and the previous chunk's project are done (W2c, Y3 and Dk
      // are free); this chunk's W1c has landed
      __syncthreads();
      copy_w2<T>(a, k, j0, W2c);
      store_dk(Dk, hc, dk);
      // expand over the rows this block reads: Y1[r][p] = sum_c W1c[r][c] Y0[p][c]
      gemm(W1c, ldc, Y0, ldc, 2 * hc, in_lo & ~15, min((in_hi + 15) & ~15, nrp), Cp,
           [&](int m, int n, float v0, float v1) {
             *reinterpret_cast<float2*>(Y1 + m * ldx + n) = make_float2(v0, v1);
           });
      __syncthreads();  // Y1 is ready and W1c free: fetch the next chunk's
      if (kn < a.K) {
        copy_w1<T>(a, kn, jn, W1c);
        load_dk<P>(a, kn, jn, dk);
      }
      // depthwise 3x3 (clamped to the region) and gate over the rows and
      // columns this block writes: a thread takes one channel, one column and
      // up to kSeg rows, sliding a 3-row window of the m and u planes down it
      const int oa = out_lo / rw, ob = out_hi / rw, nseg = (ob - oa + kSeg - 1) / kSeg;
      const int ja = left * (k + 1), nj = rw - (left + right) * (k + 1);
      const float inv_nj = 1.f / nj, inv_nseg = 1.f / nseg;
      for (int idx = threadIdx.x; idx < hc * nj * nseg; idx += kThreads) {
        const int q = div_small(idx, inv_nj), i = div_small(q, inv_nseg);
        const int j = ja + idx - q * nj, seg = q - i * nseg;
        const int col[3] = {max(j - 1, 0), j, min(j + 1, rw - 1)};
        const float* ym = Y1 + i * ldx;
        const float* yu = Y1 + (hc + i) * ldx;
        float km[9], ku[9], wm[3][3], wu[3][3];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          km[t] = Dk[t * 2 * hc + i];
          ku[t] = Dk[t * 2 * hc + hc + i];
        }
        const int ra = oa + seg * kSeg, rb = min(ra + kSeg, ob);
#pragma unroll
        for (int dr = 0; dr < 2; ++dr) {
          const int row = min(max(ra - 1 + dr, 0), rh - 1) * rw;
#pragma unroll
          for (int db = 0; db < 3; ++db) {
            wm[dr][db] = ym[row + col[db]];
            wu[dr][db] = yu[row + col[db]];
          }
        }
#pragma unroll
        for (int rr = 0; rr < kSeg; ++rr) {
          const int r = ra + rr;
          if (r >= rb) break;
          const int row = min(r + 1, rh - 1) * rw;
#pragma unroll
          for (int db = 0; db < 3; ++db) {
            wm[(rr + 2) % 3][db] = ym[row + col[db]];
            wu[(rr + 2) % 3][db] = yu[row + col[db]];
          }
          float m = 0.f, u = 0.f;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            m = fmaf(wm[(rr + t / 3) % 3][t % 3], km[t], m);
            u = fmaf(wu[(rr + t / 3) % 3][t % 3], ku[t], u);
          }
          st(Y3 + (r * rw + j) * ldh + i, __frcp_rn(1.f + __expf(-m)) * m * u);
        }
      }
      cp_async_wait_all();
      __syncthreads();  // Y3 and W2c are ready, the next W1c has landed
      // project over the rows this block writes: X[c][p] += s1 * sum_i W2c[c][i] Y3[p][i]
      gemm(W2c, ldh, Y3, ldh, Cp, out_lo & ~15, min((out_hi + 15) & ~15, nrp), hc,
           [&](int m, int n, float v0, float v1) {
             float2* px = reinterpret_cast<float2*>(X + m * ldx + n);
             float2 o = *px;
             o.x += s1 * v0;
             o.y += s1 * v1;
             *px = o;
           });
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + boff;
  const int tw = tj1 - tj0, tn = (ti1 - ti0) * tw;
  const float inv_tn = 1.f / tn, inv_tw = 1.f / tw;
  for (int idx = threadIdx.x; idx < C * tn; idx += kThreads) {
    const int c = div_small(idx, inv_tn), q = idx - c * tn;
    const int qi = div_small(q, inv_tw);
    const int gi = ti0 + qi, gj = tj0 + q - qi * tw;
    st(out + c * plane + (size_t)gi * a.W + gj, X[c * ldx + (gi - r0) * rw + gj - c0]);
  }
}

template <typename T, typename P>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.Cp, a.hc, a.nrp);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = block_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + a.tw - 1) / a.tw, (a.H + a.th - 1) / a.th, B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace blocks
}  // namespace irdu

// ns: the norm's subnets, runs of C / ns channels (an even count).
extern "C" int irdu_block_stack(const void* x, void* out, const void* scale,
                                const void* w1, const void* dwk, const void* w2,
                                const void* skip, int B, int C, int H, int W, int K,
                                int nh, long long w1_sk, long long w1_sc,
                                long long w1_sh, long long dw_sk, long long dw_st,
                                long long dw_sh, long long w2_sk, long long w2_sh,
                                long long w2_sc, int th, int tw, int hc, int dtype,
                                int pdtype, int ns, void* stream) {
  using irdu::kBFloat16;
  using irdu::kFloat32;
  using bf16 = __nv_bfloat16;
  // bf16 also needs the 16-byte weight copies of copy_w1/copy_w2: unit stride
  // along C in w1 and along H in w2, every other stride and both pointers
  // 16-byte aligned
  const bool vec_ok = w1_sc == 1 && w2_sh == 1 && w1_sh % 8 == 0 && w1_sk % 8 == 0 &&
                      w2_sc % 8 == 0 && w2_sk % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(w1) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  if (K < 1 || C < 2 || C % 2 || ns < 1 || C % ns || (C / ns) % 2 || hc < 4 || hc % 4 || 18 * hc > 2 * irdu::blocks::kThreads ||
      nh % hc || th < 1 || tw < 1 ||
      (dtype == kBFloat16 && (C % 8 || hc % 16 || !vec_ok)))
    return static_cast<int>(cudaErrorInvalidValue);
  irdu::blocks::Args a{x, out, scale, w1, dwk, w2, skip, C, H, W, K, nh, th, tw, hc, 0,
                       irdu::blocks::cpad_of(C), w1_sk, w1_sc, w1_sh, dw_sk, dw_st, dw_sh,
                       w2_sk, w2_sh, w2_sc, ns};
  a.nrp = (std::min(th + 2 * K, H) * std::min(tw + 2 * K, W) + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && pdtype == kFloat32) return irdu::blocks::launch<float, float>(a, B, s);
  if (dtype == kBFloat16 && pdtype == kFloat32) return irdu::blocks::launch<bf16, float>(a, B, s);
  if (dtype == kBFloat16 && pdtype == kBFloat16) return irdu::blocks::launch<bf16, bf16>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
