// Fused stride-1 MBConv block with BatchNorm folded, for Hopper (sm_90a).
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
// The TPU kernel keeps a whole sample's expanded map in VMEM (0.3-2.3 MB per
// sample at EffB2's widths); a Hopper block has 227 KB of shared memory, so
// the map is tiled.  A block owns a TH x TW tile of output pixels of one
// sample.  It stages the input rows and columns the tile needs (its halo,
// clipped to the map) for all C channels in shared memory once, then walks
// the expanded channels in chunks of Ec: expand the chunk over the clipped
// halo, depthwise over the tile (neighbours outside the map read as zero: the
// expanded map is zero-padded, not x), and then
//   pass 1: sum the tile's d per channel into partial[b, tile, e];
//   pass 2: scale d by the SE gate and accumulate the projection.
// SE needs the mean over the whole map before any pixel can be projected, so
// the block runs in three launches: pass 1, the SE MLP per sample (se_kernel,
// which sums the partials in tile order: deterministic), pass 2.  Pass 2
// recomputes expand and depthwise instead of storing d: nothing of the
// expanded map goes to device memory, x is read twice and out written once.
//
// Bound: at EffB2's widths the function is bound by its float32 operations
// (the 1x1 products) except the first blocks, which are bound by bytes.  This
// first design runs on the CUDA cores with 8 x 4 register tiles (expand: 8
// channels x 4 halo pixels; projection: 8 output channels x 4 pixels, one
// tile per thread, kept across the chunks), weights read through L1, and
// pays twice for the expand (both passes) and for the halo: on an H100 at
// 700 W the 19 stride-1 blocks of EffB2 at B=64 x 10 s take ~26 ms against
// a ~1.4 ms bound and ~15.6 ms for the cuDNN blocks (chip_smoke.py phase 11).
// The faster design stores d once or runs the 1x1 products on the tensor
// cores.
#include <cuda_runtime.h>

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
  float* partial;  // [B, n_tiles, E] per-tile sums of d
  float* gate;     // [B, E] SE gate
  int C, E, S, Co, H, W, Ho, Wo, k, pt, pl;
  int has_expand, has_residual;
  int TH, TW, Ec, tiles_w, n_tiles;
};

namespace {

constexpr int NT = 256;  // threads per block; ops/fused_mbconv.py::NT

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Shared-memory pitch of a halo tile: the largest clipped halo, in floats.
__host__ __device__ __forceinline__ int halo_pitch(const MBConvParams& p) {
  return round4(imin(p.TH + p.k - 1, p.H) * imin(p.TW + p.k - 1, p.W));
}

__device__ __forceinline__ float swish(float v) { return v / (1.f + expf(-v)); }

template <int PASS>
__global__ void __launch_bounds__(NT) mbconv_pass(MBConvParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b = blockIdx.y, tile = blockIdx.x;
  const int k = p.k, C = p.C, E = p.E, Ec = p.Ec;
  const int ph_pitch = halo_pitch(p);
  const int P = p.TH * p.TW, p_pitch = round4(P);
  const int x_rows = p.has_expand ? C : Ec;
  float* xs = smem;                                   // [x_rows][ph_pitch]
  float* es = xs + x_rows * ph_pitch;                 // [Ec][ph_pitch]
  float* ds = es + (p.has_expand ? Ec * ph_pitch : 0);  // [Ec][p_pitch]

  // the tile and its halo, clipped to the map
  const int r0 = (tile / p.tiles_w) * p.TH, c0 = (tile % p.tiles_w) * p.TW;
  const int hr0 = max(r0 - p.pt, 0), hc0 = max(c0 - p.pl, 0);
  const int hrows = max(min(r0 + p.TH - 1 - p.pt + k, p.H) - hr0, 0);
  const int hcols = max(min(c0 + p.TW - 1 - p.pl + k, p.W) - hc0, 0);
  const int Ph = hrows * hcols;
  const long plane = (long)p.H * p.W;
  const float* xb = p.x + (long)b * C * plane;

  // rows of x in the halo, zero beyond the channel count or the halo
  auto stage_x = [&](int ch0, int rows) {
    for (int i = tid; i < rows * ph_pitch; i += NT) {
      const int r = i / ph_pitch, hp = i - r * ph_pitch, ch = ch0 + r;
      float v = 0.f;
      if (hp < Ph && ch < C) {
        const int hr = hp / hcols, hc = hp - hr * hcols;
        v = xb[ch * plane + (long)(hr0 + hr) * p.W + hc0 + hc];
      }
      xs[i] = v;
    }
  };
  if (p.has_expand) stage_x(0, C);

  // projection tile of this thread (pass 2): 8 output channels x 4 pixels
  const int n_pg = p_pitch >> 2;
  const bool owner = tid < ((p.Co + 7) >> 3) * n_pg;
  const int cg = tid / n_pg, pg = tid - cg * n_pg;
  int co_idx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) co_idx[i] = min(cg * 8 + i, p.Co - 1);
  float pacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pacc[i][j] = 0.f;

  for (int e0 = 0; e0 < E; e0 += Ec) {
    const int ne = min(Ec, E - e0);
    const float* src;
    if (p.has_expand) {
      __syncthreads();  // xs staged / es of the last chunk no longer read
      const int n_hg = round4(Ph) >> 2, n_eg = Ec >> 3;
      for (int mt = tid; mt < n_eg * n_hg; mt += NT) {
        const int eg = mt / n_hg, hg = mt - eg * n_hg;
        int e_idx[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e_idx[i] = min(e0 + eg * 8 + i, E - 1);
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        const float* xcol = xs + hg * 4;
        for (int c = 0; c < C; ++c) {
          const float4 xv = *reinterpret_cast<const float4*>(xcol + c * ph_pitch);
          const float* wr = p.w_exp + (long)c * E;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float w = __ldg(wr + e_idx[i]);
            acc[i][0] = fmaf(w, xv.x, acc[i][0]);
            acc[i][1] = fmaf(w, xv.y, acc[i][1]);
            acc[i][2] = fmaf(w, xv.z, acc[i][2]);
            acc[i][3] = fmaf(w, xv.w, acc[i][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float bi = __ldg(p.b_exp + e_idx[i]);
          *reinterpret_cast<float4*>(es + (eg * 8 + i) * ph_pitch + hg * 4) =
              make_float4(swish(acc[i][0] + bi), swish(acc[i][1] + bi),
                          swish(acc[i][2] + bi), swish(acc[i][3] + bi));
        }
      }
      src = es;
    } else {
      __syncthreads();  // xs of the last chunk no longer read
      stage_x(e0, Ec);  // without expand, E == C: the chunk is x's channels
      src = xs;
    }
    __syncthreads();

    // depthwise over the tile, TF-SAME zeros outside the map
    for (int i = tid; i < Ec * p_pitch; i += NT) {
      const int ec = i / p_pitch, pp = i - ec * p_pitch, e = e0 + ec;
      const int ty = pp / p.TW, tx = pp - ty * p.TW;
      const int orow = r0 + ty, ocol = c0 + tx;
      float d = 0.f;
      if (pp < P && ec < ne && orow < p.Ho && ocol < p.Wo) {
        float acc = __ldg(p.b_dw + e);
        const float* s = src + ec * ph_pitch;
        for (int di = 0; di < k; ++di) {
          const int row = orow - p.pt + di;
          if (row < 0 || row >= p.H) continue;
          const float* srow = s + (row - hr0) * hcols - hc0;
          for (int dj = 0; dj < k; ++dj) {
            const int col = ocol - p.pl + dj;
            if (col < 0 || col >= p.W) continue;
            acc = fmaf(__ldg(p.w_dw + (di * k + dj) * E + e), srow[col], acc);
          }
        }
        d = swish(acc);
        if (PASS == 2) d *= p.gate[(long)b * E + e];
      }
      ds[i] = d;
    }
    __syncthreads();

    if (PASS == 1) {
      // eight lanes per channel; Ec is a multiple of 8, so a warp's four
      // channels enter and leave the loop together
      for (int ec = tid >> 3; ec < Ec; ec += NT >> 3) {
        float s = 0.f;
        for (int pp = tid & 7; pp < p_pitch; pp += 8) s += ds[ec * p_pitch + pp];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if ((tid & 7) == 0 && ec < ne)
          p.partial[((long)b * p.n_tiles + tile) * E + e0 + ec] = s;
      }
    } else if (owner) {
      for (int ec = 0; ec < ne; ++ec) {
        const float4 dv = *reinterpret_cast<const float4*>(ds + ec * p_pitch + pg * 4);
        const float* wr = p.w_proj + (long)(e0 + ec) * p.Co;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float w = __ldg(wr + co_idx[i]);
          pacc[i][0] = fmaf(w, dv.x, pacc[i][0]);
          pacc[i][1] = fmaf(w, dv.y, pacc[i][1]);
          pacc[i][2] = fmaf(w, dv.z, pacc[i][2]);
          pacc[i][3] = fmaf(w, dv.w, pacc[i][3]);
        }
      }
    }
  }

  if (PASS == 2 && owner) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int co = cg * 8 + i;
      if (co >= p.Co) break;
      const float bias = __ldg(p.b_proj + co);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = pg * 4 + j;
        const int ty = pp / p.TW, tx = pp - ty * p.TW;
        const int orow = r0 + ty, ocol = c0 + tx;
        if (pp >= P || orow >= p.Ho || ocol >= p.Wo) continue;
        float v = pacc[i][j] + bias;
        if (p.has_residual) v += xb[co * plane + (long)orow * p.W + ocol];
        p.out[(((long)b * p.Co + co) * p.Ho + orow) * p.Wo + ocol] = v;
      }
    }
  }
}

// The SE MLP of one sample: mean of d over the map from the per-tile sums,
// reduce + swish, expand + sigmoid -> gate[b, :].
__global__ void __launch_bounds__(NT) se_kernel(MBConvParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.x;
  const int E = p.E, S = p.S;
  float* mean = smem;     // [E]
  float* hid = smem + E;  // [S]
  const float inv = 1.f / (float)(p.Ho * p.Wo);
  for (int e = tid; e < E; e += NT) {
    float s = 0.f;
    for (int t = 0; t < p.n_tiles; ++t) s += p.partial[((long)b * p.n_tiles + t) * E + e];
    mean[e] = s * inv;
  }
  __syncthreads();
  for (int j = warp; j < S; j += NT / 32) {
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s = fmaf(__ldg(p.w_ser + (long)e * S + j), mean[e], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) hid[j] = swish(s + __ldg(p.b_ser + j));
  }
  __syncthreads();
  for (int e = tid; e < E; e += NT) {
    float s = __ldg(p.b_see + e);
    for (int j = 0; j < S; ++j) s = fmaf(__ldg(p.w_see + (long)j * E + e), hid[j], s);
    p.gate[(long)b * E + e] = 1.f / (1.f + expf(-s));
  }
}

}  // namespace

// Launches pass 1, the SE MLP and pass 2 on `stream`, for B samples.  The
// tile (TH x TW) and chunk (Ec) come from ops/fused_mbconv.py::plan_tiles.
// Returns cudaErrorInvalidValue for a plan the kernel cannot run, else
// cudaGetLastError() after the launches.
extern "C" int fused_mbconv_launch(const MBConvParams* params, int B, void* stream) {
  const MBConvParams p = *params;
  const int p_pitch = round4(p.TH * p.TW), ph_pitch = halo_pitch(p);
  if (p.Ec <= 0 || p.Ec % 8 || p.TH <= 0 || p.TW <= 0 || p.k <= 0 ||
      (p.has_expand == 0 && p.E != p.C) ||
      ((p.Co + 7) / 8) * (p_pitch / 4) > NT)
    return (int)cudaErrorInvalidValue;
  const long smem = 4L * ((p.has_expand ? p.C : p.Ec) * (long)ph_pitch +
                          (p.has_expand ? (long)p.Ec * ph_pitch : 0L) +
                          (long)p.Ec * p_pitch);
  const long se_smem = 4L * (p.E + p.S);
  if (smem > 232448 || se_smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (smem > 48 * 1024) {
    if ((e = cudaFuncSetAttribute(mbconv_pass<1>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
    if ((e = cudaFuncSetAttribute(mbconv_pass<2>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
  }
  if (se_smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(se_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)se_smem)) != cudaSuccess)
    return (int)e;
  const dim3 grid(p.n_tiles, B);
  mbconv_pass<1><<<grid, NT, smem, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  se_kernel<<<B, NT, se_smem, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mbconv_pass<2><<<grid, NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}
