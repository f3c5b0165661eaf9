// Native (C++) input pipeline of irdu_tpu_torch: batched patch assembly with
// bit-exact numpy-legacy RNG. A copy of irdu_tpu/data/native/irdu_data.cc
// with the same C interface and the same arithmetic; only comments differ.
//
// The analogue of the reference's torch `DataLoader(num_workers=4)` worker
// pool: the per-item hot path (crop -> symmetric pad -> /16 floor ->
// dihedral augment -> normalize -> additive-Gaussian degradation) runs in
// C++ threads, off the Python thread that drives the card.
//
// Determinism contract: item content is a pure function of (seed, idx),
// matching irdu_tpu_torch/data/dataset.py::PatchDataset.__getitem__
// (and JAX's irdu_tpu/data/dataset.py, of which it is a copy) BIT-EXACTLY.
// That requires re-implementing the exact numpy stack the Python path uses:
//   np.random.RandomState(np.random.MT19937(np.random.SeedSequence((seed, idx))))
//   -> SeedSequence entropy-pool hash (O'Neill seed_seq_fe, as in numpy
//      _bit_generator.pyx), MT19937 state = generate_state(624),
//   -> legacy polar-method gaussians (randomkit rk_gauss),
//   -> legacy masked-rejection bounded randint,
//   -> RandomState.choice via cumsum + searchsorted(side='right').
// Parity is asserted by tests/test_torch_native_data.py against numpy itself
// and against JAX's PatchDataset.__getitem__.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// SeedSequence (numpy _bit_generator.pyx, pool_size=4, no spawn key)
// ---------------------------------------------------------------------------

constexpr uint32_t XSHIFT = 16;
constexpr uint32_t INIT_A = 0x43b0d7e5u;
constexpr uint32_t MULT_A = 0x931e8875u;
constexpr uint32_t INIT_B = 0x8b51f9ddu;
constexpr uint32_t MULT_B = 0x58f38dedu;
constexpr uint32_t MIX_MULT_L = 0xca01f9ddu;
constexpr uint32_t MIX_MULT_R = 0x4973f715u;
constexpr int POOL_SIZE = 4;

struct SeedSequence {
  uint32_t pool[POOL_SIZE];

  static uint32_t hashmix(uint32_t value, uint32_t* hash_const) {
    value ^= *hash_const;
    *hash_const *= MULT_A;
    value *= *hash_const;
    value ^= value >> XSHIFT;
    return value;
  }

  static uint32_t mix(uint32_t x, uint32_t y) {
    uint32_t result = MIX_MULT_L * x - MIX_MULT_R * y;
    result ^= result >> XSHIFT;
    return result;
  }

  // entropy: already coerced to uint32 words (numpy _coerce_to_uint32_array)
  explicit SeedSequence(const std::vector<uint32_t>& entropy) {
    uint32_t hash_const = INIT_A;
    const int ne = static_cast<int>(entropy.size());
    for (int i = 0; i < POOL_SIZE; ++i) {
      pool[i] = hashmix(i < ne ? entropy[i] : 0u, &hash_const);
    }
    for (int i_src = 0; i_src < POOL_SIZE; ++i_src) {
      for (int i_dst = 0; i_dst < POOL_SIZE; ++i_dst) {
        if (i_src != i_dst) {
          pool[i_dst] = mix(pool[i_dst], hashmix(pool[i_src], &hash_const));
        }
      }
    }
    for (int i_src = POOL_SIZE; i_src < ne; ++i_src) {
      for (int i_dst = 0; i_dst < POOL_SIZE; ++i_dst) {
        pool[i_dst] = mix(pool[i_dst], hashmix(entropy[i_src], &hash_const));
      }
    }
  }

  void generate_state(uint32_t* out, int n) const {
    uint32_t hash_const = INIT_B;
    int src_idx = 0;
    for (int i = 0; i < n; ++i) {
      uint32_t data_val = pool[src_idx];
      data_val ^= hash_const;
      hash_const *= MULT_B;
      data_val *= hash_const;
      data_val ^= data_val >> XSHIFT;
      out[i] = data_val;
      src_idx = (src_idx + 1) % POOL_SIZE;
    }
  }
};

// (seed, idx) -> uint32 entropy words, little-endian chunks per int, at
// least one word each (numpy _coerce_to_uint32_array on a tuple of ints).
std::vector<uint32_t> entropy_words(uint64_t seed, uint64_t idx) {
  std::vector<uint32_t> out;
  for (uint64_t v : {seed, idx}) {
    if (v == 0) {
      out.push_back(0u);
    } else {
      while (v > 0) {
        out.push_back(static_cast<uint32_t>(v & 0xffffffffull));
        v >>= 32;
      }
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// MT19937 core + numpy-legacy distributions
// ---------------------------------------------------------------------------

constexpr int MT_N = 624;
constexpr int MT_M = 397;
constexpr uint32_t MATRIX_A = 0x9908b0dfu;
constexpr uint32_t UPPER_MASK = 0x80000000u;
constexpr uint32_t LOWER_MASK = 0x7fffffffu;

struct LegacyRandomState {
  uint32_t key[MT_N];
  int pos;
  bool has_gauss;
  double gauss;

  explicit LegacyRandomState(uint64_t seed, uint64_t idx)
      : pos(MT_N - 1), has_gauss(false), gauss(0.0) {
    // numpy MT19937(seed_seq) semantics (verified empirically against
    // np.random.MT19937(...).state): key = seed_seq.generate_state(624)
    // with key[0] forced to 0x80000000 (non-zero-state guarantee), and
    // pos = 623 — the first output is temper(key[623]), then a refill.
    SeedSequence ss(entropy_words(seed, idx));
    ss.generate_state(key, MT_N);
    key[0] = 0x80000000u;
  }

  uint32_t next_u32() {
    if (pos >= MT_N) {
      for (int i = 0; i < MT_N - MT_M; ++i) {
        uint32_t y = (key[i] & UPPER_MASK) | (key[i + 1] & LOWER_MASK);
        key[i] = key[i + MT_M] ^ (y >> 1) ^ ((y & 1) ? MATRIX_A : 0u);
      }
      for (int i = MT_N - MT_M; i < MT_N - 1; ++i) {
        uint32_t y = (key[i] & UPPER_MASK) | (key[i + 1] & LOWER_MASK);
        key[i] = key[i + (MT_M - MT_N)] ^ (y >> 1) ^ ((y & 1) ? MATRIX_A : 0u);
      }
      uint32_t y = (key[MT_N - 1] & UPPER_MASK) | (key[0] & LOWER_MASK);
      key[MT_N - 1] = key[MT_M - 1] ^ (y >> 1) ^ ((y & 1) ? MATRIX_A : 0u);
      pos = 0;
    }
    uint32_t y = key[pos++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }

  // randomkit rk_double (dividing by 2^53 == multiplying by 2^-53 exactly)
  double next_double() {
    uint32_t a = next_u32() >> 5;
    uint32_t b = next_u32() >> 6;
    return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0);
  }

  // legacy_gauss (polar method, cached second value)
  double next_gauss() {
    if (has_gauss) {
      has_gauss = false;
      return gauss;
    }
    double f, x1, x2, r2;
    do {
      x1 = 2.0 * next_double() - 1.0;
      x2 = 2.0 * next_double() - 1.0;
      r2 = x1 * x1 + x2 * x2;
    } while (r2 >= 1.0 || r2 == 0.0);
    f = std::sqrt(-2.0 * std::log(r2) / r2);
    gauss = f * x1;
    has_gauss = true;
    return f * x2;
  }

  // legacy randint(0, high_exclusive) for small ranges: masked rejection on
  // buffered 32-bit draws (numpy _bounded_integers buffered_bounded_masked)
  uint32_t next_bounded(uint32_t rng_inclusive) {
    uint32_t mask = rng_inclusive;
    mask |= mask >> 1;
    mask |= mask >> 2;
    mask |= mask >> 4;
    mask |= mask >> 8;
    mask |= mask >> 16;
    uint32_t v;
    do {
      v = next_u32() & mask;
    } while (v > rng_inclusive);
    return v;
  }

  // RandomState.choice(levels, p): cumsum(p) -> searchsorted(sample, 'right')
  int next_choice(const double* probs, int n) {
    std::vector<double> cdf(n);
    double acc = 0.0;
    for (int i = 0; i < n; ++i) {
      acc += probs[i];
      cdf[i] = acc;
    }
    for (int i = 0; i < n; ++i) cdf[i] /= acc;
    double u = next_double();
    // searchsorted side='right': first index where cdf[idx] > u
    int idx = 0;
    while (idx < n - 1 && cdf[idx] <= u) ++idx;
    return idx;
  }
};

// ---------------------------------------------------------------------------
// Patch assembly (mirrors PatchDataset.__getitem__)
// ---------------------------------------------------------------------------

// numpy mode="symmetric" index folding for bottom/right padding only
// (the dataset pads (0, ph-h), (0, pw-w)).
inline int symmetric_index(int i, int n) {
  // reflect-with-edge-repeat, periodic with period 2n (numpy tiles the
  // pattern [0..n-1, n-1..0, ...] when the pad is wider than the source).
  const int k = i % (2 * n);
  return k < n ? k : 2 * n - 1 - k;
}

struct ItemSpec {
  const uint8_t* image;  // HWC uint8, 3 channels
  int img_h, img_w;
  int row, col;          // crop origin (absolute in image)
  bool padding;          // tile smaller than patch: crop to edge + sym pad
};

// dihedral source-index mapping on the SQUARE (n x n) patch:
// out[i][j] = in[si][sj]. Matches np.rot90 (counter-clockwise) / np.flipud.
inline void dihedral_src(int mode, int n, int i, int j, int* si, int* sj) {
  switch (mode) {
    case 0: *si = i;           *sj = j;           break;  // identity
    case 1: *si = n - 1 - i;   *sj = j;           break;  // flipud
    case 2: *si = j;           *sj = n - 1 - i;   break;  // rot90
    case 3: *si = j;           *sj = i;           break;  // flipud(rot90)
    case 4: *si = n - 1 - i;   *sj = n - 1 - j;   break;  // rot180
    case 5: *si = i;           *sj = n - 1 - j;   break;  // flipud(rot180)
    case 6: *si = n - 1 - j;   *sj = i;           break;  // rot270
    case 7: *si = n - 1 - j;   *sj = n - 1 - i;   break;  // flipud(rot270)
  }
}

struct BatchParams {
  int ph, pw;          // requested patch size
  int oh, ow;          // output size after /16 floor
  uint64_t seed;
  bool use_aug;
  int dist_mode;       // 0 none, 1 addictive, 2 scale, 3 vary
  const double* levels;
  const double* probs;
  int n_levels;
  double lambda_noise;
  bool clip;
};

void assemble_item(const ItemSpec& it, int64_t idx, const BatchParams& p,
                   float* out_noisy, float* out_clean) {
  LegacyRandomState rs(p.seed, static_cast<uint64_t>(idx));

  const int C = 3;
  const int oh = p.oh, ow = p.ow;

  // clean patch in uint8 (crop + symmetric pad + /16 floor + augment),
  // matching the Python op order exactly (augment acts on uint8).
  std::vector<uint8_t> patch(static_cast<size_t>(oh) * ow * C);

  // pre-pad extent: Python crops img[row:row+ph, col:col+pw], so the
  // actual patch is min(ph, H-row) x min(pw, W-col) (padding=true tiles
  // may be smaller than the patch on either side independently).
  const int ch = std::min(p.ph, it.img_h - it.row);
  const int cw = std::min(p.pw, it.img_w - it.col);

  int aug_mode = 0;
  // RNG order in __getitem__: augment mode first, then noise.
  // (augment is drawn only when enabled — same as Python)
  // Build un-augmented uint8 patch rows first.
  std::vector<uint8_t> base(static_cast<size_t>(oh) * ow * C);
  for (int i = 0; i < oh; ++i) {
    const int si = symmetric_index(i, ch);
    const uint8_t* src_row =
        it.image + (static_cast<size_t>(it.row + si) * it.img_w) * C;
    uint8_t* dst_row = base.data() + static_cast<size_t>(i) * ow * C;
    if (i < ch && ow <= cw) {
      // fully interior row: straight copy
      std::memcpy(dst_row, src_row + static_cast<size_t>(it.col) * C,
                  static_cast<size_t>(ow) * C);
    } else {
      for (int j = 0; j < ow; ++j) {
        const int sj = symmetric_index(j, cw);
        const uint8_t* px = src_row + static_cast<size_t>(it.col + sj) * C;
        dst_row[j * C + 0] = px[0];
        dst_row[j * C + 1] = px[1];
        dst_row[j * C + 2] = px[2];
      }
    }
  }

  if (p.use_aug) {
    aug_mode = static_cast<int>(rs.next_bounded(6));  // randint(0,7): 0..6
  }
  if (aug_mode == 0) {
    patch.swap(base);
  } else {
    // square guaranteed by the caller (oh == ow)
    const int n = oh;
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) {
        int si, sj;
        dihedral_src(aug_mode, n, i, j, &si, &sj);
        const uint8_t* s = base.data() + (static_cast<size_t>(si) * n + sj) * C;
        uint8_t* d = patch.data() + (static_cast<size_t>(i) * n + j) * C;
        d[0] = s[0];
        d[1] = s[1];
        d[2] = s[2];
      }
    }
  }

  // normalize + degrade. Python: patch.astype(f32)/255;
  // noise drawn f64 (C-order), cast f32, added in f32.
  const size_t total = static_cast<size_t>(oh) * ow * C;
  double scale = 0.0;
  bool direct_sigma = false;  // noise = N(0, sigma/255) directly
  switch (p.dist_mode) {
    case 1:
      scale = p.lambda_noise / 255.0;
      direct_sigma = true;
      break;
    case 2:
      scale = p.lambda_noise / 255.0;  // N(0,1) then * scale — identical math
      break;
    case 3: {
      int k = rs.next_choice(p.probs, p.n_levels);
      scale = p.levels[k] / 255.0;
      direct_sigma = true;
      break;
    }
    default:
      break;
  }
  (void)direct_sigma;  // N(0,1)*s and N(0,s) produce identical doubles here:
  // legacy_normal is loc + scale*gauss, and mode 2's python-side
  // `noise * (sigma/255.)` is the same single f64 multiply.

  for (size_t t = 0; t < total; ++t) {
    const float clean = static_cast<float>(patch[t]) / 255.0f;
    out_clean[t] = clean;
    float noisy = clean;
    if (p.dist_mode != 0) {
      const float nz = static_cast<float>(scale * rs.next_gauss());
      noisy = clean + nz;
    }
    if (p.clip) {
      noisy = noisy < 0.0f ? 0.0f : (noisy > 1.0f ? 1.0f : noisy);
    }
    out_noisy[t] = noisy;
  }
}

}  // namespace

extern "C" {

// Parity probe for tests: fill `out` with n draws of the given kind from
// RandomState(MT19937(SeedSequence((seed, idx)))).
//   kind 0: raw uint32 (as double)
//   kind 1: randint(0, 7) legacy draws
//   kind 2: standard normals (legacy polar)
//   kind 3: random_sample doubles
//   kind 4: choice indices over probs[0:n_levels] (one draw each)
void irdu_rng_probe(uint64_t seed, uint64_t idx, int kind, int n,
                    const double* probs, int n_levels, double* out) {
  LegacyRandomState rs(seed, idx);
  for (int i = 0; i < n; ++i) {
    switch (kind) {
      case 0: out[i] = static_cast<double>(rs.next_u32()); break;
      case 1: out[i] = static_cast<double>(rs.next_bounded(6)); break;
      case 2: out[i] = rs.next_gauss(); break;
      case 3: out[i] = rs.next_double(); break;
      case 4: out[i] = static_cast<double>(rs.next_choice(probs, n_levels)); break;
    }
  }
}

// Assemble a batch of (noisy, clean) float32 HWC pairs.
// images: n_items pointers to uint8 HWC source images (3 channels).
// Returns 0 on success, nonzero on invalid arguments.
int irdu_make_pairs(
    const uint8_t* const* images, const int32_t* img_hw,  // n*2: (h, w)
    const int32_t* crops,                                 // n*2: (row, col)
    const uint8_t* pad_flags, int32_t n_items, int32_t ph, int32_t pw,
    uint64_t seed, const int64_t* indices, int32_t use_aug,
    int32_t dist_mode, const double* levels, const double* probs,
    int32_t n_levels, double lambda_noise, int32_t clip,
    float* out_noisy, float* out_clean, int32_t n_threads) {
  const int oh = (ph / 16) * 16;
  const int ow = (pw / 16) * 16;
  if (oh <= 0 || ow <= 0) return 1;
  if (use_aug && oh != ow) return 2;  // dihedral needs square output
  if (dist_mode == 3 && (n_levels <= 0 || levels == nullptr || probs == nullptr))
    return 3;

  BatchParams p;
  p.ph = ph;
  p.pw = pw;
  p.oh = oh;
  p.ow = ow;
  p.seed = seed;
  p.use_aug = use_aug != 0;
  p.dist_mode = dist_mode;
  p.levels = levels;
  p.probs = probs;
  p.n_levels = n_levels;
  p.lambda_noise = lambda_noise;
  p.clip = clip != 0;

  const size_t item_elems = static_cast<size_t>(oh) * ow * 3;

  auto work = [&](int lo, int hi) {
    for (int k = lo; k < hi; ++k) {
      ItemSpec it;
      it.image = images[k];
      it.img_h = img_hw[2 * k];
      it.img_w = img_hw[2 * k + 1];
      it.row = crops[2 * k];
      it.col = crops[2 * k + 1];
      it.padding = pad_flags[k] != 0;
      assemble_item(it, indices[k], p, out_noisy + item_elems * k,
                    out_clean + item_elems * k);
    }
  };

  int nt = n_threads;
  if (nt <= 1 || n_items <= 1) {
    work(0, n_items);
    return 0;
  }
  if (nt > n_items) nt = n_items;
  std::vector<std::thread> threads;
  const int per = (n_items + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int lo = t * per;
    const int hi = lo + per < n_items ? lo + per : n_items;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
