// Fused stride-1 MBConv block with BatchNorm folded, for Hopper (sm_90a):
// the depthwise output stored once, weights staged in shared memory, both
// 1x1 products on the tensor cores in a 3xTF32 split.
//
// Replaces the TPU kernel audiocaption_tpu/ops/pallas_mbconv.py
// (_mbconv_s1_kernel :102-159, launched by fused_mbconv_s1 :162-204).
//
// The block, on NCHW float32 activations x [B, C, H, W] -> out [B, Co, Ho, Wo]:
//   e = swish(W_exp^T x + b_exp)                (1x1 expand; e = x without)
//   d = swish(depthwise_k(pad0(e)) + b_dw)       (TF-SAME zeros around e)
//   g = sigmoid(W_see^T swish(W_ser^T mean_hw(d) + b_ser) + b_see)
//   out = W_proj^T (g * d) + b_proj (+ x)
// Weights are those of ops/fused_mbconv.py::pack_mbconv: w_exp [C, E],
// w_dw [k, k, E], w_ser [E, S], w_see [S, E], w_proj [E, Co], 1-D biases.
//
// Three launches.  SE needs the mean of d over the whole map before any
// pixel can be projected, so d is stored once, to a [B, E, Ho, Wo] scratch:
//   1. expand_dw_kernel: one block per (output tile of TH x TW pixels, group
//      of Eg expanded channels, sample).  It stages x over the tile's halo
//      (clipped to the map) for all C channels in one pass, then walks its
//      channels in chunks of Ec, the chunk's w_exp and w_dw double-buffered
//      in shared memory by cp.async: the expand over the halo as a tensor-
//      core product (below), bias and swish; the depthwise, each thread one
//      (channel, output column) walking down the tile's rows with its k x k
//      window and weights in registers (k new inputs a row; zeros outside
//      the map by predicate), swish; d written to the scratch (lanes along
//      columns: coalesced) and the tile's per-channel sums, column sums
//      added in column order, to partial[b, tile, e].  Without expand the
//      staged x is the depthwise input.
//   2. se_kernel: the SE MLP per sample, 1024 threads, summing the partials
//      in tile order (deterministic, no atomics); the reduce product reads
//      w_ser along its rows (coalesced), in row slices added in order.
//   3. project_kernel: per sample the GEMM out_b = W_proj^T (g_b * d_b) +
//      b_proj (+ x), tiled BM x BN (output channels x pixels) over 8 warps,
//      E in chunks of 32 double-buffered by cp.async (16-byte copies where
//      rows are 16-byte aligned); the gate scales the W_proj fragment as it
//      is loaded, bias and residual in the epilogue.
//
// Tensor cores: mma.sync.m16n8k8 TF32, each warp a 16 x 32 tile.  The port
// keeps float32 accuracy (TF32 is off for parity), so every operand is
// split as big = tf32(v), small = tf32(v - big), and a product is
// a_small * b_big + a_big * b_small + a_big * b_big, accumulated in float32
// (3xTF32: the dropped small * small term is ~2^-22 relative).
// ops/fused_mbconv.py::mbconv_split_tf32 emulates the split on the CPU.
//
// Bound: at EffB2's widths the function is bound by its operations, ~85%
// of them in the 1x1 products, which run here at the 3xTF32 rate (a third
// of the TF32 peak); the rest (depthwise, swish, SE) runs on the CUDA
// cores.  The d scratch costs a write and a read of B * E * Ho * Wo floats
// (855 MB for the 17 expand blocks of EffB2 at B=64 x 10 s), in place of
// a second expand over every tile's halo.
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored by ops/fused_mbconv.py::_Params (ctypes): pointers, then ints.
// Outside the unnamed namespace: the extern "C" entry point takes it.
struct MBConvParams {
  const float* x;
  float* out;
  const float* w_exp;
  const float* b_exp;
  const float* w_dw;
  const float* b_dw;
  const float* w_ser;
  const float* b_ser;
  const float* w_see;
  const float* b_see;
  const float* w_proj;
  const float* b_proj;
  float* d;        // [B, E, Ho, Wo] depthwise output (after swish)
  float* partial;  // [B, n_tiles, E] per-tile sums of d
  float* gate;     // [B, E] SE gate
  int C, E, S, Co, H, W, Ho, Wo, k, pt, pl;
  int has_expand, has_residual;
  int TH, TW, Ec, Eg, tiles_w, n_tiles, WM;
};

namespace {

constexpr int NT = 256;     // threads per block; ops/fused_mbconv.py::NT
constexpr int NWARP = NT / 32;
constexpr int KC = 32;      // projection: E per chunk
constexpr int SE_NT = 1024; // threads of the SE block; ops/fused_mbconv.py::SE_NT

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Shared memory of expand_dw_kernel, in floats (ops/fused_mbconv.py::
// tile_smem mirrors it): x over the halo [x_rows][ld] (ld: the largest
// clipped halo, rounded to 32, + 8 so that fragment loads hit 32 banks),
// the chunk's expanded halo [Ec][ld], w_exp chunks [2][c8][Ec + 8], w_dw
// chunks [2][k * k][Ec], the depthwise's column sums [Ec][TW].
struct Pass1Layout {
  int ld, c8, x_rows, es, wexp, wdw, red, total;
};

__host__ __device__ __forceinline__ Pass1Layout pass1_layout(const MBConvParams& p) {
  Pass1Layout L;
  L.ld = round_up(imin(p.TH + p.k - 1, p.H) * imin(p.TW + p.k - 1, p.W), 32) + 8;
  L.c8 = round_up(p.C, 8);
  L.x_rows = p.has_expand ? L.c8 : p.C;
  L.es = L.x_rows * L.ld;
  L.wexp = L.es + (p.has_expand ? p.Ec * L.ld : 0);
  L.wdw = L.wexp + (p.has_expand ? 2 * L.c8 * (p.Ec + 8) : 0);
  L.red = L.wdw + 2 * p.k * p.k * p.Ec;
  L.total = L.red + p.Ec * p.TW;
  return L;
}

__host__ __device__ __forceinline__ long project_smem_floats(int WM, int E) {
  const int BM = 16 * WM, BN = 32 * (NWARP / WM);
  return 2L * KC * (BM + 8) + 2L * KC * (BN + 8) + round_up(E, KC);
}

__device__ __forceinline__ float swish(float v) { return v / (1.f + expf(-v)); }

// 4-byte asynchronous copy global -> shared; zeros when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}
// 16-byte asynchronous copy global -> shared of `bytes` (0-16) bytes, the
// rest zero-filled; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// dst[r * sld + c] = src[r * gld + c] for r < rows, c < cols (a multiple of
// 4), zero where r >= rv or c >= cv, by cp.async: 16-byte copies when gld
// and src are 16-byte aligned (sld and dst must be), else 4-byte ones.
__device__ __forceinline__ void tile_async(float* dst, int sld, const float* src,
                                           long gld, int rows, int cols, int rv,
                                           int cv, int tid) {
  if ((gld & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int c4 = cols >> 2;
    for (int i = tid; i < rows * c4; i += NT) {
      const int r = i / c4, c = (i - r * c4) << 2;
      const int n = r < rv ? imax(imin(cv - c, 4), 0) : 0;
      cp_async16(dst + r * sld + c, n > 0 ? src + r * gld + c : src, 4 * n);
    }
  } else {
    for (int i = tid; i < rows * cols; i += NT) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < rv && c < cv;
      cp_async4(dst + r * sld + c, ok ? src + r * gld + c : src, ok);
    }
  }
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += A[0:16, 0:K] B[0:K, 8j:8j+8] for j < 4, in 3xTF32, where
// A[m][k] = A_s[k * lda + m] * (scale ? scale[k] : 1) and B[k][n] =
// B_s[k * ldb + n] (both k-major in shared memory; lda, ldb = 8 mod 16).
// Fragments of m16n8k8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void warp_tile_3xtf32(float (&acc)[4][4],
                                                 const float* A_s, int lda,
                                                 const float* B_s, int ldb,
                                                 int K, const float* scale,
                                                 int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float* a_lo = A_s + (k0 + t) * lda + g;
    const float* a_hi = a_lo + 4 * lda;
    float av[4] = {a_lo[0], a_lo[8], a_hi[0], a_hi[8]};
    if (scale != nullptr) {
      const float s0 = scale[k0 + t], s1 = scale[k0 + t + 4];
      av[0] *= s0;
      av[1] *= s0;
      av[2] *= s1;
      av[3] *= s1;
    }
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ab[i], as[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* bp = B_s + (k0 + t) * ldb + 8 * j + g;
      uint32_t bb[2], bs[2];
      split_tf32(bp[0], bb[0], bs[0]);
      split_tf32(bp[4 * ldb], bb[1], bs[1]);
      mma_tf32(acc[j], as, bb);
      mma_tf32(acc[j], ab, bs);
      mma_tf32(acc[j], ab, bb);
    }
  }
}

// The depthwise of one chunk: channels e0 + [0, ne) of the tile at (r0, c0),
// from src rows of the clipped halo (row ec of `src` is channel e0 + ec,
// stride ld; the halo's first row and column on the map are hr0, hc0, its
// width hcols), weights wd [K * K][Ec].  d to the scratch; the sum of each
// (channel, column) over the tile's rows to red[ec * TW + tx].
template <int K>
__device__ __forceinline__ void depthwise_chunk(const MBConvParams& p,
                                                const float* src, int ld,
                                                const float* wd, float* red,
                                                int b, int e0, int ne, int r0,
                                                int c0, int hr0, int hc0,
                                                int hcols, int tid) {
  const int TW = p.TW, rows = imin(p.TH, p.Ho - r0);
  const long plane = (long)p.Ho * p.Wo;
  for (int pair = tid; pair < ne * TW; pair += NT) {
    const int ec = pair / TW, tx = pair - ec * TW, ocol = c0 + tx;
    float sum = 0.f;
    if (ocol < p.Wo) {
      const float* s = src + ec * ld;
      float wt[K][K], win[K][K];
      int cofs[K];
      bool cok[K];
#pragma unroll
      for (int i = 0; i < K * K; ++i) wt[i / K][i % K] = wd[i * p.Ec + ec];
#pragma unroll
      for (int dj = 0; dj < K; ++dj) {
        const int col = ocol - p.pl + dj;
        cok[dj] = col >= 0 && col < p.W;
        cofs[dj] = col - hc0;
      }
      // row `row` of the map into w, zeros outside it (the index stays
      // inside the halo either way)
      auto load_row = [&](int row, float (&w)[K]) {
        const bool rok = row >= 0 && row < p.H;
#pragma unroll
        for (int dj = 0; dj < K; ++dj) {
          const bool ok = rok && cok[dj];
          const float v = s[ok ? (row - hr0) * hcols + cofs[dj] : 0];
          w[dj] = ok ? v : 0.f;
        }
      };
#pragma unroll
      for (int i = 0; i < K - 1; ++i) load_row(r0 - p.pt + i, win[i + 1]);
      const int e = e0 + ec;
      const float bias = __ldg(p.b_dw + e);
      float* dcol = p.d + ((long)b * p.E + e) * plane + (long)r0 * p.Wo + ocol;
      for (int ty = 0; ty < rows; ++ty) {
#pragma unroll
        for (int i = 0; i < K - 1; ++i)
#pragma unroll
          for (int dj = 0; dj < K; ++dj) win[i][dj] = win[i + 1][dj];
        load_row(r0 + ty - p.pt + K - 1, win[K - 1]);
        float acc = bias;
#pragma unroll
        for (int di = 0; di < K; ++di)
#pragma unroll
          for (int dj = 0; dj < K; ++dj) acc = fmaf(wt[di][dj], win[di][dj], acc);
        const float v = swish(acc);
        dcol[(long)ty * p.Wo] = v;
        sum += v;
      }
    }
    red[pair] = sum;
  }
}

template <int K>
__global__ void __launch_bounds__(NT, 2) expand_dw_kernel(MBConvParams p) {
  extern __shared__ __align__(16) float smem[];
  const Pass1Layout L = pass1_layout(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, b = blockIdx.z;
  const int e_begin = blockIdx.y * p.Eg, e_end = imin(e_begin + p.Eg, p.E);
  const int C = p.C, E = p.E, Ec = p.Ec, ld = L.ld;
  float* xs = smem;
  float* es = p.has_expand ? smem + L.es : xs;
  float* wexp_s = smem + L.wexp;
  float* wdw_s = smem + L.wdw;
  float* red = smem + L.red;

  // the tile and its halo, clipped to the map
  const int tr = tile / p.tiles_w;
  const int r0 = tr * p.TH, c0 = (tile - tr * p.tiles_w) * p.TW;
  const int hr0 = max(r0 - p.pt, 0), hc0 = max(c0 - p.pl, 0);
  const int hrows = max(imin(r0 + p.TH - 1 - p.pt + K, p.H) - hr0, 0);
  const int hcols = max(imin(c0 + p.TW - 1 - p.pl + K, p.W) - hc0, 0);
  const int Ph = hrows * hcols;
  const long plane = (long)p.H * p.W;
  const float* xb = p.x + (long)b * C * plane;

  // x over the halo, all channels in one pass, by cp.async (rows past C
  // zero-filled); it joins the first chunk's group
  for (int rr = warp; rr < L.x_rows * hrows; rr += NWARP) {
    const int c = rr / hrows, hr = rr - c * hrows;
    float* dst = xs + c * ld + hr * hcols;
    const float* src = c < C ? xb + c * plane + (long)(hr0 + hr) * p.W + hc0 : xb;
    for (int hc = lane; hc < hcols; hc += 32)
      cp_async4(dst + hc, c < C ? src + hc : xb, c < C);
  }
  const int tail = ld - Ph;   // columns past the halo: zero
  for (int i = tid; i < L.x_rows * tail; i += NT) {
    const int c = i / tail;
    xs[c * ld + Ph + (i - c * tail)] = 0.f;
  }

  // the weights of the chunk at e0 into buffer buf, zeros past the group
  auto issue = [&](int e0, int buf) {
    if (p.has_expand)
      tile_async(wexp_s + buf * L.c8 * (Ec + 8), Ec + 8, p.w_exp + e0, E, L.c8,
                 Ec, C, e_end - e0, tid);
    tile_async(wdw_s + buf * K * K * Ec, Ec, p.w_dw + e0, E, K * K, Ec, K * K,
               e_end - e0, tid);
    cp_async_commit();
  };
  issue(e_begin, 0);

  int buf = 0;
  for (int e0 = e_begin; e0 < e_end; e0 += Ec, buf ^= 1) {
    if (e0 + Ec < e_end) {
      issue(e0 + Ec, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk's weights and x are in

    if (p.has_expand) {
      // es[0:Ec, halo] = swish(w_exp chunk^T xs + b_exp): warp tiles 16 x 32
      const float* wx = wexp_s + buf * L.c8 * (Ec + 8);
      const int mt = Ec / 16, n_wt = mt * ((ld - 8) / 32);
      const int g = lane >> 2, t = lane & 3;
      for (int wt = warp; wt < n_wt; wt += NWARP) {
        const int mi = wt % mt, ni = wt / mt;
        float acc[4][4] = {};
        warp_tile_3xtf32(acc, wx + mi * 16, Ec + 8, xs + ni * 32, ld, L.c8,
                         nullptr, lane);
        const int e_lo = e0 + mi * 16 + g, e_hi = e_lo + 8;
        const float b_lo = e_lo < e_end ? __ldg(p.b_exp + e_lo) : 0.f;
        const float b_hi = e_hi < e_end ? __ldg(p.b_exp + e_hi) : 0.f;
        float* row_lo = es + (mi * 16 + g) * ld + ni * 32 + 2 * t;
        float* row_hi = row_lo + 8 * ld;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<float2*>(row_lo + 8 * j) =
              make_float2(swish(acc[j][0] + b_lo), swish(acc[j][1] + b_lo));
          *reinterpret_cast<float2*>(row_hi + 8 * j) =
              make_float2(swish(acc[j][2] + b_hi), swish(acc[j][3] + b_hi));
        }
      }
      __syncthreads();
    }

    // depthwise (TF-SAME zeros outside the map), d to the scratch; the
    // tile's per-channel sums, column by column, to partial
    const int ne = imin(Ec, e_end - e0);
    depthwise_chunk<K>(p, p.has_expand ? es : xs + e0 * ld, ld,
                       wdw_s + buf * K * K * Ec, red, b, e0, ne, r0, c0, hr0,
                       hc0, hcols, tid);
    __syncthreads();
    for (int ec = tid; ec < ne; ec += NT) {
      float sum = 0.f;
      for (int tx = 0; tx < p.TW; ++tx) sum += red[ec * p.TW + tx];
      p.partial[((long)b * p.n_tiles + tile) * E + e0 + ec] = sum;
    }
    __syncthreads();  // es, red and this buffer are the next chunks'
  }
}

// The SE MLP of one sample: mean of d over the map from the per-tile sums,
// reduce + swish, expand + sigmoid -> gate[b, :].  Needs S <= SE_NT.
__global__ void __launch_bounds__(SE_NT) se_kernel(MBConvParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int E = p.E, S = p.S, R = SE_NT / S;
  float* mean = smem;       // [E]
  float* hid = mean + E;    // [S]
  float* part = hid + S;    // [R][S] row-slice sums of the reduce product
  const float inv = 1.f / (float)(p.Ho * p.Wo);
  const float* pb = p.partial + (long)b * p.n_tiles * E;
  for (int e = tid; e < E; e += SE_NT) {
    float s = 0.f;
    for (int t = 0; t < p.n_tiles; ++t) s += pb[(long)t * E + e];
    mean[e] = s * inv;
  }
  __syncthreads();
  // thread (r, j) sums w_ser[e, j] mean[e] over the rows e = r mod R
  if (tid < R * S) {
    const int r = tid / S, j = tid - r * S;
    float s = 0.f;
    for (int e = r; e < E; e += R) s = fmaf(__ldg(p.w_ser + (long)e * S + j), mean[e], s);
    part[tid] = s;
  }
  __syncthreads();
  for (int j = tid; j < S; j += SE_NT) {
    float s = __ldg(p.b_ser + j);
    for (int r = 0; r < R; ++r) s += part[r * S + j];
    hid[j] = swish(s);
  }
  __syncthreads();
  for (int e = tid; e < E; e += SE_NT) {
    float s = __ldg(p.b_see + e);
#pragma unroll 4
    for (int j = 0; j < S; ++j) s = fmaf(__ldg(p.w_see + (long)j * E + e), hid[j], s);
    p.gate[(long)b * E + e] = 1.f / (1.f + expf(-s));
  }
}

// out[b, co, n] = sum_e w_proj[e, co] g[b, e] d[b, e, n] + b_proj[co]
// (+ x[b, co, n]), n over the Ho * Wo pixels: a BM x BN tile per block,
// WM x (8 / WM) warps of 16 x 32.
template <int WM>
__global__ void __launch_bounds__(NT, 2) project_kernel(MBConvParams p) {
  constexpr int BM = 16 * WM, BN = 32 * (NWARP / WM), LDA = BM + 8, LDB = BN + 8;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                  // [2][KC][LDA]  w_proj chunk
  float* Bs = As + 2 * KC * LDA;     // [2][KC][LDB]  d chunk
  float* gs = Bs + 2 * KC * LDB;     // [round_up(E, KC)] gate
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, n_blk = blockIdx.x * BN, m_blk = blockIdx.y * BM;
  const int E = p.E, Co = p.Co, P = p.Ho * p.Wo;
  const float* db = p.d + (long)b * E * P;

  auto issue = [&](int k0, int buf) {
    tile_async(As + buf * KC * LDA, LDA, p.w_proj + (long)k0 * Co + m_blk, Co,
               KC, BM, E - k0, Co - m_blk, tid);
    tile_async(Bs + buf * KC * LDB, LDB, db + (long)k0 * P + n_blk, P, KC, BN,
               E - k0, P - n_blk, tid);
    cp_async_commit();
  };
  issue(0, 0);
  for (int e = tid; e < round_up(E, KC); e += NT)
    gs[e] = e < E ? p.gate[(long)b * E + e] : 0.f;

  const int wm = warp % WM, wn = warp / WM;
  float acc[4][4] = {};
  int buf = 0;
  for (int k0 = 0; k0 < E; k0 += KC, buf ^= 1) {
    if (k0 + KC < E) {
      issue(k0 + KC, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    warp_tile_3xtf32(acc, As + buf * KC * LDA + wm * 16, LDA,
                     Bs + buf * KC * LDB + wn * 32, LDB, KC, gs + k0, lane);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  const float* xb = p.x + (long)b * Co * P;   // residual: C == Co
  float* ob = p.out + (long)b * Co * P;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int co = m_blk + wm * 16 + g + 8 * half;
    if (co >= Co) continue;
    const float bias = __ldg(p.b_proj + co);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n_blk + wn * 32 + 8 * j + 2 * t + q;
        if (n >= P) continue;
        float v = acc[j][2 * half + q] + bias;
        if (p.has_residual) v += xb[(long)co * P + n];
        ob[(long)co * P + n] = v;
      }
  }
}

template <int WM>
cudaError_t launch_project(const MBConvParams& p, int B, cudaStream_t s) {
  constexpr int BM = 16 * WM, BN = 32 * (NWARP / WM);
  const long smem = 4 * project_smem_floats(WM, p.E);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(project_kernel<WM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Ho * p.Wo + BN - 1) / BN, (p.Co + BM - 1) / BM, B);
  project_kernel<WM><<<grid, NT, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of the three launches, in bytes, for a plan.
extern "C" long fused_mbconv_smem_bytes(const MBConvParams* params, int which) {
  const MBConvParams& p = *params;
  if (which == 0) return 4L * pass1_layout(p).total;
  if (which == 1) return 4L * (p.E + p.S + SE_NT);
  return 4L * project_smem_floats(p.WM, p.E);
}

// Launches expand_dw_kernel, the SE MLP and project_kernel on `stream`, for
// B samples.  The tile (TH x TW), chunk (Ec), channel group (Eg) and the
// projection's warp rows (WM) come from ops/fused_mbconv.py::plan_tiles.
// Returns cudaErrorInvalidValue for a plan the kernel cannot run, else
// cudaGetLastError() after the launches.
extern "C" int fused_mbconv_launch(const MBConvParams* params, int B, void* stream) {
  const MBConvParams p = *params;
  if (p.Ec <= 0 || p.Ec % 16 || p.Eg <= 0 || p.Eg % p.Ec || p.TH <= 0 ||
      p.TW <= 0 || (p.k != 3 && p.k != 5) || p.S <= 0 || p.S > SE_NT ||
      (p.has_expand == 0 && p.E != p.C) ||
      (p.WM != 1 && p.WM != 2 && p.WM != 4))
    return (int)cudaErrorInvalidValue;
  const long smem1 = fused_mbconv_smem_bytes(&p, 0);
  const long se_smem = fused_mbconv_smem_bytes(&p, 1);
  const long smem3 = fused_mbconv_smem_bytes(&p, 2);
  if (smem1 > 232448 || se_smem > 232448 || smem3 > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  auto pass1 = p.k == 3 ? expand_dw_kernel<3> : expand_dw_kernel<5>;
  if (smem1 > 48 * 1024 &&
      (e = cudaFuncSetAttribute(pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem1)) != cudaSuccess)
    return (int)e;
  if (se_smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(se_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)se_smem)) != cudaSuccess)
    return (int)e;
  const dim3 grid1(p.n_tiles, (p.E + p.Eg - 1) / p.Eg, B);
  pass1<<<grid1, NT, smem1, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  se_kernel<<<B, SE_NT, se_smem, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  switch (p.WM) {
    case 1: e = launch_project<1>(p, B, s); break;
    case 2: e = launch_project<2>(p, B, s); break;
    default: e = launch_project<4>(p, B, s); break;
  }
  return (int)e;
}
