// Block-level building blocks shared by the fused greedy and beam decode
// kernels (fused_greedy.cu, fused_beam.cu).
//
// One thread block owns one sample and all of its rows (1 row for greedy,
// K beam rows for beam search) and runs the whole decode loop.  Every
// function here is called by all threads of the block; each ends with a
// __syncthreads() so its result is visible block-wide.  Activations live
// in shared memory, weights and caches in global memory (the weights,
// ~12.5 MB in float32 at the flagship width, stay resident in the 50 MB
// L2 across blocks and steps).  All accumulation is float32.
//
// Packed per-layer weight layout (float32, [out, in] row-major, matching
// pack_decoder_weights in decoding/fused_greedy.py):
//   wqkv [3E, E]  (q rows pre-scaled by 1/sqrt(dh))   bqkv [3E]
//   wo   [E, E]   bo  [E]
//   xwq  [E, E]   (pre-scaled)                         xbq [E]
//   xwo  [E, E]   xbo [E]
//   w1   [F, E]   b1  [F]
//   w2   [E, F]   b2  [E]
//   ln   [6, E]   (norm1 gamma, beta, norm2 gamma, beta, norm3 gamma, beta)
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ACD_NT 512          // threads per block
#define ACD_RMAX 4          // most rows (beams) one block holds
#define ACD_MASKED (-1e30f) // masked attention score (the TPU kernel's fill)

struct LayerOffsets {
  long wqkv, bqkv, wo, bo, xwq, xbq, xwo, xbo, w1, b1, w2, b2, ln, size;
};

__host__ __device__ inline LayerOffsets layer_offsets(int E, int F) {
  LayerOffsets o;
  long p = 0;
  o.wqkv = p; p += 3L * E * E;
  o.bqkv = p; p += 3L * E;
  o.wo = p;   p += (long)E * E;
  o.bo = p;   p += E;
  o.xwq = p;  p += (long)E * E;
  o.xbq = p;  p += E;
  o.xwo = p;  p += (long)E * E;
  o.xbo = p;  p += E;
  o.w1 = p;   p += (long)F * E;
  o.b1 = p;   p += F;
  o.w2 = p;   p += (long)E * F;
  o.b2 = p;   p += E;
  o.ln = p;   p += 6L * E;
  o.size = p;
  return o;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (value, index) arg-max: larger value wins, equal values go to the lower
// index (lax.top_k / jnp.argmax tie order).
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2,
                                             int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    argmax_merge(v, i, v2, i2);
  }
}

// Block-wide arg-max; every thread gets the result.  red_v / red_i hold at
// least 32 entries of shared memory.
__device__ inline void block_argmax(float& v, int& i, float* red_v,
                                    int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? red_v[lane] : -INFINITY;
    i = lane < nw ? red_i[lane] : 0x7fffffff;
    warp_argmax(v, i);
    if (lane == 0) {
      red_v[0] = v;
      red_i[0] = i;
    }
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
  __syncthreads();
}

// Block-wide sum or max; every thread gets the result.
__device__ inline float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nw ? red[lane] : (is_max ? -INFINITY : 0.f);
    w = is_max ? warp_max(w) : warp_sum(w);
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// Y[r, o] = act(sum_i W[o, i] X[r, i] + bias[o]) for r < R, o < n_out.
// One warp per output row: the row of W is read once (float4, coalesced)
// and applied to all R activation rows.  n_in, ldx and W's rows are
// multiples of 4 floats.  bias may be null.
__device__ inline void matvec(const float* __restrict__ W,
                              const float* __restrict__ bias, const float* X,
                              int ldx, float* Y, int ldy, int R, int n_out,
                              int n_in, bool relu) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = warp; o < n_out; o += nw) {
    const float* w = W + (long)o * n_in;
    float acc[ACD_RMAX];
#pragma unroll
    for (int r = 0; r < ACD_RMAX; ++r) acc[r] = 0.f;
    for (int i = lane * 4; i < n_in; i += 128) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(w + i));
#pragma unroll
      for (int r = 0; r < ACD_RMAX; ++r) {
        if (r < R) {
          const float4 xv = *reinterpret_cast<const float4*>(X + r * ldx + i);
          acc[r] += wv.x * xv.x + wv.y * xv.y + wv.z * xv.z + wv.w * xv.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ACD_RMAX; ++r) {
      if (r < R) {
        float s = warp_sum(acc[r]);
        if (lane == 0) {
          if (bias) s += bias[o];
          if (relu) s = fmaxf(s, 0.f);
          Y[r * ldy + o] = s;
        }
      }
    }
  }
  __syncthreads();
}

// x[r] = LayerNorm(x[r] + y[r]) * gamma + beta, eps 1e-5, two-pass
// variance.  One warp per row.
__device__ inline void add_layernorm(float* x, const float* y,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta, int R,
                                     int E) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < R) {
    float* xr = x + warp * E;
    const float* yr = y + warp * E;
    float s = 0.f;
    for (int e = lane; e < E; e += 32) {
      xr[e] += yr[e];
      s += xr[e];
    }
    const float mean = warp_sum(s) / (float)E;
    float ss = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float d = xr[e] - mean;
      ss += d * d;
    }
    const float rs = rsqrtf(warp_sum(ss) / (float)E + 1e-5f);
    for (int e = lane; e < E; e += 32)
      xr[e] = (xr[e] - mean) * rs * gamma[e] + beta[e];
  }
  __syncthreads();
}

// Multi-head attention of R query rows against T keys.
//   q      [R, ldq] shared, head h in columns [h*dh, (h+1)*dh)
//   K, V   row r, key j at K + r*kv_row_stride + j*E (kv_row_stride = 0 when
//          all rows share one memory)
//   valid  row r, key j at valid[r*valid_row_stride + j]; nonzero = attend
//          (self attention: the not-a-pad-token flags of positions <= t)
//   scores [R*H*T] shared scratch;  ctx [R, E] shared output
// Masked keys score ACD_MASKED, so a row whose keys are all masked attends
// uniformly, as on the TPU.
// K and V are not __restrict__: the self caches are written by this kernel,
// and a restrict-qualified read may go through the non-coherent read-only
// cache and see a stale line.
__device__ inline void attention(const float* q, int ldq, const float* K,
                                 const float* V,
                                 long kv_row_stride,
                                 const unsigned char* valid,
                                 int valid_row_stride, int T, int R, int E,
                                 int H, float* scores, float* ctx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int dh = E / H;
  const int n_pairs = R * H * T;
  // scores: one warp per (row, head, key)
  for (int p = warp; p < n_pairs; p += nw) {
    const int j = p % T, rh = p / T, h = rh % H, r = rh / H;
    const float* qr = q + r * ldq + h * dh;
    const float* kr = K + r * kv_row_stride + (long)j * E + h * dh;
    float s = 0.f;
    for (int d = lane; d < dh; d += 32) s += qr[d] * kr[d];
    s = warp_sum(s);
    if (lane == 0)
      scores[p] = valid[r * valid_row_stride + j] ? s : ACD_MASKED;
  }
  __syncthreads();
  // softmax over keys: one warp per (row, head)
  for (int rh = warp; rh < R * H; rh += nw) {
    float* sr = scores + rh * T;
    float m = -INFINITY;
    for (int j = lane; j < T; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) sr[j] = sr[j] / sum;
  }
  __syncthreads();
  // context: one thread per (row, feature)
  for (int re = threadIdx.x; re < R * E; re += blockDim.x) {
    const int r = re / E, e = re % E, h = e / dh;
    const float* pr = scores + (r * H + h) * T;
    const float* vr = V + r * kv_row_stride + e;
    float acc = 0.f;
    for (int j = 0; j < T; ++j) acc += pr[j] * vr[(long)j * E];
    ctx[re] = acc;
  }
  __syncthreads();
}

// Shared-memory work area of one block.
struct Smem {
  float* x;       // [R, E]   hidden state
  float* qkv;     // [R, 3E]  self-attention projections
  float* ctx;     // [R, E]
  float* tmp;     // [R, E]   sublayer output
  float* hid;     // [R, F]   FFN hidden
  float* scores;  // [R, H, max(L, S)]
  unsigned char* self_valid;  // [R, L] 1 where the fed token is not <pad>
};

// One pass of the hidden state x (R rows at position t) through all
// decoder layers.  Self K/V caches: layer i's K for row r, position j at
// self_k[i*layer_stride + r*row_stride + j*E] (V likewise).  This step's
// K/V are written at row t first.  mem_k/mem_v: layer i's memory at
// mem_k[i*mem_layer_stride], [S, E], shared by all R rows.
__device__ inline void decoder_layers(
    const float* __restrict__ layers, const LayerOffsets& off, Smem sm,
    float* self_k, float* self_v, long layer_stride, long row_stride,
    const float* mem_k, const float* mem_v,
    long mem_layer_stride, const unsigned char* mem_valid, int nlayers,
    int t, int L, int S, int R, int E, int H, int F) {
  for (int i = 0; i < nlayers; ++i) {
    const float* w = layers + (long)i * off.size;
    float* kc = self_k + (long)i * layer_stride;
    float* vc = self_v + (long)i * layer_stride;
    // self attention
    matvec(w + off.wqkv, w + off.bqkv, sm.x, E, sm.qkv, 3 * E, R, 3 * E, E,
           false);
    for (int re = threadIdx.x; re < R * E; re += blockDim.x) {
      const int r = re / E, e = re % E;
      kc[r * row_stride + (long)t * E + e] = sm.qkv[r * 3 * E + E + e];
      vc[r * row_stride + (long)t * E + e] = sm.qkv[r * 3 * E + 2 * E + e];
    }
    __syncthreads();
    attention(sm.qkv, 3 * E, kc, vc, row_stride, sm.self_valid, L, t + 1, R,
              E, H, sm.scores, sm.ctx);
    matvec(w + off.wo, w + off.bo, sm.ctx, E, sm.tmp, E, R, E, E, false);
    add_layernorm(sm.x, sm.tmp, w + off.ln, w + off.ln + E, R, E);
    // cross attention on the precomputed memory K/V
    matvec(w + off.xwq, w + off.xbq, sm.x, E, sm.qkv, 3 * E, R, E, E, false);
    attention(sm.qkv, 3 * E, mem_k + (long)i * mem_layer_stride,
              mem_v + (long)i * mem_layer_stride, 0, mem_valid, 0, S, R, E, H,
              sm.scores, sm.ctx);
    matvec(w + off.xwo, w + off.xbo, sm.ctx, E, sm.tmp, E, R, E, E, false);
    add_layernorm(sm.x, sm.tmp, w + off.ln + 2 * E, w + off.ln + 3 * E, R, E);
    // feed-forward
    matvec(w + off.w1, w + off.b1, sm.x, E, sm.hid, F, R, F, E, true);
    matvec(w + off.w2, w + off.b2, sm.hid, F, sm.tmp, E, R, E, F, false);
    add_layernorm(sm.x, sm.tmp, w + off.ln + 4 * E, w + off.ln + 5 * E, R, E);
  }
}

// x[r] = emb[word[r]] * sqrt_e + pe[t]
__device__ inline void embed_rows(const float* __restrict__ emb,
                                  const float* __restrict__ pe,
                                  const int* word, float* x, int R, int E,
                                  int t, float sqrt_e) {
  for (int re = threadIdx.x; re < R * E; re += blockDim.x) {
    const int r = re / E, e = re % E;
    x[re] = emb[(long)word[r] * E + e] * sqrt_e + pe[(long)t * E + e];
  }
  __syncthreads();
}

// Carve the shared work area; returns the bytes used.  Offsets stay
// multiples of 4 floats (float4 loads).
__host__ __device__ inline long carve_smem(char* base, Smem* sm, int R, int E,
                                           int F, int H, int L, int S) {
  const int T = L > S ? L : S;
  long p = 0;
  auto take = [&](long n_floats) {
    float* ptr = reinterpret_cast<float*>(base + p);
    p += ((n_floats + 3) / 4) * 4 * sizeof(float);
    return ptr;
  };
  float* x = take((long)R * E);
  float* qkv = take(3L * R * E);
  float* ctx = take((long)R * E);
  float* tmp = take((long)R * E);
  float* hid = take((long)R * F);
  float* scores = take((long)R * H * T);
  unsigned char* sv = reinterpret_cast<unsigned char*>(take(((long)R * L + 3) / 4));
  if (sm) {
    sm->x = x;
    sm->qkv = qkv;
    sm->ctx = ctx;
    sm->tmp = tmp;
    sm->hid = hid;
    sm->scores = scores;
    sm->self_valid = sv;
  }
  return p;
}
