// K2: softmax edge weights of the latent graphs over a window of E offsets,
// CHW. Replaces irdu_tpu/ops/pallas/solver_chw.py:edge_weights_chw
// (_edgew_kernel). Design and bound: see irdu_tpu_torch/ops/edge_weights.py.
//
// One CTA per (batch, graph) and tile of bh rows by bw = tx * PX columns;
// tx * bh threads, each taking PX adjacent pixels of one row (PX = 8 in
// bf16, 4 in f32: one 16-byte vector). With c the centre's F features, n a
// neighbour's and m the metric diagonal, the similarity of the normalized,
// metric-scaled features is  sum_f c_f n_f m_f^2 / (max(|c|,eps) max(|n|,eps)).
// The features are walked in chunks of fc planes. Per chunk the CTA copies
// the tile plus R rows above and below (R = 1 for cross-4 and ring-8, 2 for
// diamond-12; rows clamped to the image, the replicate pad) and kPad columns
// on each side into shared memory, 16 bytes at a time by cp.async when W is a
// multiple of the vector (else element by element), and fills the 2 columns beyond each
// image edge with the edge's values; then every position's squared features
// are added to Nsq (once per position, shared by the neighbours that read
// it), and each thread reads, per feature, its pixels' 2R + 1 rows as strips
// of PX + 4 columns (16-byte shared loads in the middle) and adds its E
// metric-weighted dots in registers, the window's offsets compile-time
// constants. After the last chunk Nsq becomes 1 / max(|.|, eps); each
// thread scales its dots by the strips of inverse norms, takes the f32
// softmax over E, and writes each edge's PX outputs with one 16-byte store
// (element stores on a ragged edge). The metric comes in its own dtype.

#include <cstdint>

#include "common.cuh"

namespace irdu {
namespace ew {

constexpr int kPad = 8;  // shared-memory columns left and right of the tile
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline size_t seg16(size_t n) { return (n + 15) / 16 * 16; }

// Must match irdu_tpu_torch/ops/edge_weights.py:edge_smem_bytes.
__host__ __device__ inline size_t smem_bytes(int esize, int fc, int F, int bh, int tx, int R) {
  const size_t rows = bh + 2 * R, cols = tx * (16 / esize) + 2 * kPad;
  return seg16((size_t)esize * fc * rows * cols) + seg16(4 * rows * cols) + 4 * (size_t)F;
}

// n / d for 0 <= n < 2^22 and d > 0, by one f32 multiply with inv = 1 / d
// (the f32 error of (n + 0.5) * inv stays below 0.5 / d, so truncation gives
// the exact quotient).
__device__ __forceinline__ int div_small(int n, float inv) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The built-in windows: E = 4 is cross-4 (radius 1), E = 8 ring-8 (the 3x3
// ring, radius 1), E = 12 diamond-12 (radius 2), in the edge order of
// ops/windows.py; with a constant e the offsets fold away.
template <int E>
struct Win;
template <>
struct Win<4> {
  static constexpr int R = 1;
  static __device__ __forceinline__ int dh(int e) { return dh_of(e); }
  static __device__ __forceinline__ int dw(int e) { return dw_of(e); }
};
template <>
struct Win<8> {  // row-major over the 3x3 ring: (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1)
  static constexpr int R = 1;
  static __device__ __forceinline__ int dh(int e) { return e < 3 ? -1 : (e < 5 ? 0 : 1); }
  static __device__ __forceinline__ int dw(int e) {
    constexpr int t[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
    return t[e];
  }
};
template <>
struct Win<12> {
  static constexpr int R = 2;
  static __device__ __forceinline__ int dh(int e) { return d12_dh(e); }
  static __device__ __forceinline__ int dw(int e) { return d12_dw(e); }
};

// PX pixels of type T: one 16-byte vector. load() reads PX values at a
// 16-byte aligned place of shared memory as f32; strip() reads columns
// -2 .. PX + 1 around it (a 4- or 8-byte load on each side); store() writes
// PX outputs with one 16-byte store.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kPx = 4;
  static __device__ __forceinline__ void strip(const float* p, float (&s)[kPx + 4]) {
    const float2 l = *reinterpret_cast<const float2*>(p - 2);
    const float4 c = *reinterpret_cast<const float4*>(p);
    const float2 r = *reinterpret_cast<const float2*>(p + 4);
    s[0] = l.x, s[1] = l.y, s[2] = c.x, s[3] = c.y, s[4] = c.z, s[5] = c.w, s[6] = r.x, s[7] = r.y;
  }
  static __device__ __forceinline__ void load(const float* p, float (&x)[kPx]) {
    const float4 c = *reinterpret_cast<const float4*>(p);
    x[0] = c.x, x[1] = c.y, x[2] = c.z, x[3] = c.w;
  }
  static __device__ __forceinline__ void store(float* dst, const float (&v)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kPx = 8;
  static __device__ __forceinline__ float2 pair(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
  static __device__ __forceinline__ void strip(const __nv_bfloat16* p, float (&s)[kPx + 4]) {
    const float2 l = pair(*reinterpret_cast<const uint32_t*>(p - 2));
    const uint4 c = *reinterpret_cast<const uint4*>(p);
    const float2 r = pair(*reinterpret_cast<const uint32_t*>(p + 8));
    const float2 c0 = pair(c.x), c1 = pair(c.y), c2 = pair(c.z), c3 = pair(c.w);
    s[0] = l.x, s[1] = l.y, s[2] = c0.x, s[3] = c0.y, s[4] = c1.x, s[5] = c1.y;
    s[6] = c2.x, s[7] = c2.y, s[8] = c3.x, s[9] = c3.y, s[10] = r.x, s[11] = r.y;
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[kPx]) {
    const uint4 c = *reinterpret_cast<const uint4*>(p);
    const float2 c0 = pair(c.x), c1 = pair(c.y), c2 = pair(c.z), c3 = pair(c.w);
    x[0] = c0.x, x[1] = c0.y, x[2] = c1.x, x[3] = c1.y, x[4] = c2.x, x[5] = c2.y;
    x[6] = c3.x, x[7] = c3.y;
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
};

// The f32 strip of columns -2 .. PX + 1 around p in a row of f32 norms.
template <int PX>
__device__ __forceinline__ void strip_f32(const float* p, float (&s)[PX + 4]) {
  const float2 l = *reinterpret_cast<const float2*>(p - 2);
  const float2 r = *reinterpret_cast<const float2*>(p + PX);
  s[0] = l.x, s[1] = l.y, s[PX + 2] = r.x, s[PX + 3] = r.y;
#pragma unroll
  for (int q = 0; q < PX; q += 4) {
    const float4 c = *reinterpret_cast<const float4*>(p + q);
    s[q + 2] = c.x, s[q + 3] = c.y, s[q + 4] = c.z, s[q + 5] = c.w;
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(256, 2)
    edge_weights_kernel(const T* __restrict__ feats, const void* __restrict__ mm, int m_bf16,
                        T* __restrict__ out, int G, int F, int H, int W, int bh, int tx, int fc) {
  constexpr int PX = Vec<T>::kPx, V = PX, R = Win<E>::R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bw = tx * PX, cols = bw + 2 * kPad, rows = bh + 2 * R, area = rows * cols;
  T* X = reinterpret_cast<T*>(smem);                                    // (fc, rows, cols)
  float* Nsq = reinterpret_cast<float*>(smem + seg16(sizeof(T) * fc * area));  // (rows, cols)
  float* M2 = Nsq + seg16(4 * area) / 4;                               // (F,)
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int bg = blockIdx.z, g = bg % G;  // bg = b * G + g
  const int i0 = blockIdx.y * bh, j0 = blockIdx.x * bw, c_lo = j0 - kPad;
  const size_t hw = (size_t)H * W;
  const T* base = feats + (size_t)bg * F * hw;
  for (int f = tid; f < F; f += nthr) {
    const float m = m_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(mm)[g * F + f])
                           : static_cast<const float*>(mm)[g * F + f];
    M2[f] = m * m;
  }
  for (int idx = tid; idx < area; idx += nthr) Nsq[idx] = 0.f;

  // this thread's row and PX pixels; row rr + R + dh of a plane of X holds
  // image row i + dh (clamped), and the columns within 2 of the image's
  // edges hold the replicate pad, so neighbour (dh, dw) of pixel p is
  // column p + dw of that row's strip
  const int rr = tid / tx, jb = j0 + (tid - rr * tx) * PX, i = i0 + rr;
  const bool mine = i < H && jb < W;
  const int at = (rr + R) * cols + jb - c_lo;  // pixel 0's place in a plane
  float dot[PX][E];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int e = 0; e < E; ++e) dot[p][e] = 0.f;

  const bool vec = W % V == 0;  // 16-byte chunks start and end inside a row
  const int cv = cols / V;
  // the 16-byte chunks inside the image, [q_lo, q_hi) of a row; the columns
  // the element copies fill: [e_lo, e_hi) of the band (all of them when W is
  // not a multiple of V), of which only those outside [0, W) when it is
  const int q_lo = max(-c_lo, 0) / V, q_hi = min(W - c_lo, cols) / V, nq = q_hi - q_lo;
  const int e_lo = max(c_lo, -2) - c_lo, e_hi = min(c_lo + cols, W + 2) - c_lo;
  const int ne = vec ? (e_hi - e_lo) - V * nq : e_hi - e_lo;
  const float inv_nq = 1.f / nq, inv_ne = 1.f / max(ne, 1), inv_rows = 1.f / rows;
  for (int f0 = 0; f0 < F; f0 += fc) {
    const int nf = min(fc, F - f0);
    __syncthreads();  // the previous chunk is read
    if (vec) {
      for (int idx = tid; idx < nf * rows * nq; idx += nthr) {
        const int fr = div_small(idx, inv_nq), q = q_lo + idx - fr * nq;
        const int f = div_small(fr, inv_rows), r = fr - f * rows;
        const int gr = min(max(i0 - R + r, 0), H - 1);
        cp_async16(X + (size_t)fr * cols + q * V,
                   base + (f0 + f) * hw + (size_t)gr * W + c_lo + q * V);
      }
    }
    for (int idx = tid; idx < nf * rows * ne; idx += nthr) {
      const int fr = div_small(idx, inv_ne), f = div_small(fr, inv_rows), r = fr - f * rows;
      int c = e_lo + idx - fr * ne;  // with vec, the pad left of column 0, then right of W - 1
      if (vec && c >= V * q_lo) c += V * nq;
      const int gr = min(max(i0 - R + r, 0), H - 1);
      X[(size_t)fr * cols + c] = base[(f0 + f) * hw + (size_t)gr * W + min(max(c_lo + c, 0), W - 1)];
    }
    if (vec) asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    // squared norms of every position, V columns at a time
    for (int idx = tid; idx < rows * cv; idx += nthr) {
      float sq[V];
      float* n = Nsq + idx * V;
#pragma unroll
      for (int v = 0; v < V; ++v) sq[v] = n[v];
      for (int f = 0; f < nf; ++f) {
        float x[V];
        Vec<T>::load(X + f * area + idx * V, x);
#pragma unroll
        for (int v = 0; v < V; ++v) sq[v] = fmaf(x[v], x[v], sq[v]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) n[v] = sq[v];
    }
    if (mine) {  // the E metric-weighted dots of this thread's pixels
      for (int f = 0; f < nf; ++f) {
        const T* Xf = X + f * area + at;
        const float m2 = M2[f0 + f];
        float s[PX + 4], cm[PX];
        Vec<T>::strip(Xf, s);
#pragma unroll
        for (int p = 0; p < PX; ++p) cm[p] = s[p + 2] * m2;
#pragma unroll
        for (int q = 0; q <= 2 * R; ++q) {  // rows 0, -1, .., -R, 1, .., R
          const int dh = q <= R ? -q : q - R;
          if (q > 0) Vec<T>::strip(Xf + dh * cols, s);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (Win<E>::dh(e) != dh) continue;
#pragma unroll
            for (int p = 0; p < PX; ++p)
              dot[p][e] = fmaf(cm[p], s[p + 2 + Win<E>::dw(e)], dot[p][e]);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < area / 4; idx += nthr) {
    float4 v = reinterpret_cast<float4*>(Nsq)[idx];
    v.x = 1.f / fmaxf(sqrtf(v.x), 1e-12f);
    v.y = 1.f / fmaxf(sqrtf(v.y), 1e-12f);
    v.z = 1.f / fmaxf(sqrtf(v.z), 1e-12f);
    v.w = 1.f / fmaxf(sqrtf(v.w), 1e-12f);
    reinterpret_cast<float4*>(Nsq)[idx] = v;
  }
  __syncthreads();
  if (!mine) return;

  // similarities: dot / (|c| |n|), the inverse norms read row by row
  float s[PX + 4];
#pragma unroll
  for (int dh = -R; dh <= R; ++dh) {
    strip_f32<PX>(Nsq + at + dh * cols, s);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (Win<E>::dh(e) != dh) continue;
#pragma unroll
      for (int p = 0; p < PX; ++p) dot[p][e] *= s[p + 2 + Win<E>::dw(e)];
    }
  }
  strip_f32<PX>(Nsq + at, s);
#pragma unroll
  for (int p = 0; p < PX; ++p) {  // the f32 softmax over E
    float mx = dot[p][0] * s[p + 2];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dot[p][e] *= s[p + 2];
      mx = fmaxf(mx, dot[p][e]);
    }
    float den = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dot[p][e] = __expf(dot[p][e] - mx);
      den += dot[p][e];
    }
    const float inv = __frcp_rn(den);
#pragma unroll
    for (int e = 0; e < E; ++e) dot[p][e] *= inv;
  }
  T* dst = out + (size_t)bg * E * hw + (size_t)i * W + jb;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float v[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) v[p] = dot[p][e];
    if (W % PX == 0) {  // jb + PX <= W, 16-byte aligned
      Vec<T>::store(dst + e * hw, v);
    } else {
#pragma unroll
      for (int p = 0; p < PX; ++p)
        if (jb + p < W) st(dst + e * hw + p, v[p]);
    }
  }
}

template <typename T, int E>
int launch(const void* feats, const void* m, int m_bf16, void* out, int B, int G, int F, int H,
           int W, int bh, int tx, int fc, cudaStream_t s) {
  constexpr int PX = Vec<T>::kPx;
  const size_t smem = smem_bytes(sizeof(T), fc, F, bh, tx, Win<E>::R);
  auto kern = edge_weights_kernel<T, E>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + tx * PX - 1) / (tx * PX), (H + bh - 1) / bh, B * G);
  kern<<<grid, tx * bh, smem, s>>>(static_cast<const T*>(feats), m, m_bf16, static_cast<T*>(out),
                                   G, F, H, W, bh, tx, fc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* feats, const void* m, int m_bf16, void* out, int n_edges, int B, int G,
             int F, int H, int W, int bh, int tx, int fc, cudaStream_t s) {
  switch (n_edges) {
    case 4: return launch<T, 4>(feats, m, m_bf16, out, B, G, F, H, W, bh, tx, fc, s);
    case 8: return launch<T, 8>(feats, m, m_bf16, out, B, G, F, H, W, bh, tx, fc, s);
    default: return launch<T, 12>(feats, m, m_bf16, out, B, G, F, H, W, bh, tx, fc, s);
  }
}

}  // namespace ew
}  // namespace irdu

// Shared memory of one CTA for a plan (the plan's check).
extern "C" long long irdu_edge_weights_smem(int esize, int fc, int F, int bh, int tx, int R) {
  return static_cast<long long>(irdu::ew::smem_bytes(esize, fc, F, bh, tx, R));
}

// feats (B, G*F, H, W) and out (B, G, E, H, W) in dtype; multi_m (G, F) f32
// (mdtype 0) or bf16 (1), contiguous; n_edges 4 (cross-4), 8 (ring-8) or 12
// (diamond-12), the windows of ops/windows.py; the plan (bh rows, tx
// threads a row, fc features a chunk) of edge_weights.plan_edge_tiles.
extern "C" int irdu_edge_weights(const void* feats, const void* multi_m, void* out, int B,
                                 int G, int F, int H, int W, int n_edges, int dtype, int mdtype,
                                 int bh, int tx, int fc, void* stream) {
  using namespace irdu::ew;
  if ((n_edges != 4 && n_edges != 8 && n_edges != 12) || B < 1 || G < 1 || F < 1 || H < 1 || W < 1 ||
      bh < 1 || tx < 1 || tx * bh > 256 || fc < 1 || fc > F ||
      (mdtype != irdu::kFloat32 && mdtype != irdu::kBFloat16) ||
      (dtype != irdu::kFloat32 && dtype != irdu::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == irdu::kFloat32 ? 4 : 2;
  if (smem_bytes(esize, fc, F, bh, tx, n_edges == 12 ? 2 : 1) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mb = mdtype == irdu::kBFloat16;
  return dtype == irdu::kFloat32
             ? dispatch<float>(feats, multi_m, mb, out, n_edges, B, G, F, H, W, bh, tx, fc, s)
             : dispatch<__nv_bfloat16>(feats, multi_m, mb, out, n_edges, B, G, F, H, W, bh, tx,
                                       fc, s);
}

extern "C" const char* irdu_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
