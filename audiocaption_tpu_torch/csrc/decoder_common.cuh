// Cluster-level building blocks shared by the fused greedy and beam decode
// kernels (fused_greedy.cu, fused_beam.cu).
//
// Work split.  A thread block cluster of C blocks (C = 8, or 16 with the
// non-portable size) owns a tile of R rows: ns samples with all their beams
// (R = ns * K; K = 1 for greedy) for the whole decode loop.  Each weight
// matrix of a step is split across the cluster by output columns, in units
// of 16-row m-tiles: block c owns m-tiles [c*Mt/C, (c+1)*Mt/C) of wqkv, wo,
// xwq, xwo, w1, w2 and of the tied vocabulary.  So each block streams only
// ~1/C of the decoder weights from L2 a step, and applies every weight load
// to all R rows of the tile.
//
// Products.  Weights are packed on the host in mma fragment order
// (decoding/fused_greedy.py::frag_pack): [Mt][Kt][32 lanes][4], so one
// warp reads one 16 x 8 tile as one coalesced float4 a lane, streamed
// through a per-warp cp.async ring that runs ahead across phases.  The
// rows are the mma's N side (8 a tile, up to 4 tiles: R <= 32), read from
// shared memory.  The products run on the FP64 tensor cores (mma.sync
// m8n8k4 f64): a product of two float32 values is exact in float64 and
// the sums are float64, so each output is rounded once (attention and
// LayerNorm sum in float64 too).  A first version with 3xTF32 products on
// the TF32 tensor cores and float32 sums drifted from the float32 plain
// version further than the plain version's own distance from the same
// search in float64; this one stays closer to float64 than the float32
// plain version does (chip_smoke.py phase 3).
// When a block owns fewer m-tiles than it has warps, K is split across
// warps and the partials are added in a fixed order.
//
// Exchange.  Each block writes its output columns into its own buffer and
// copies them (float4 stores) into every other block's through
// distributed shared memory, then the cluster syncs once
// (barrier.cluster arrive.release / wait.acquire, which also orders the
// self K/V cache stores in global memory).  Residual add
// and LayerNorm run redundantly in every block on whole rows, so every
// block holds the same hidden state bit for bit.  Self and cross attention
// are split by (row, head) across the cluster's warps; the self K/V caches
// live in global memory (L2), written once per (row, position) by the
// block that owns those K/V columns, and read through a per-row ancestry
// table (anc): a beam's history is its parents' rows, so a reorder copies
// a few bytes of table, never the cache.
//
// Syncs per step: 8 per layer (qkv, self attention, wo, xq, cross
// attention, xwo, w1, w2) plus 1 for the greedy pick or 2 for the beam pick
// (log-sum-exp partials, then local top-K candidates).  On an H100 one
// sync costs ~0.5 us and ~1 us with a 1 KB exchange a peer
// (decoding/fused_greedy.py::cluster_sync_ns); a step's phases, their
// products and attention, cost far more (PERF.md).
//
// Modes (DecodeArgs.mode; the TPU kernels' bf16 options, each its own
// instantiation of a kernel: template <typename CT, bool WB>):
//   ACD_CACHE_BF16   the memory K/V and the self K/V caches are stored in
//                    bf16 (CT = __nv_bfloat16): written rounded once, read
//                    as 8-byte loads of four values and widened; the sums
//                    stay float64 (storage only, as on the TPU).
//   ACD_WEIGHTS_BF16 the fragment-packed matrices and the embedding table
//                    are bf16 (WB); each product rounds its activations to
//                    bf16 as it loads them and runs on the bf16 tensor
//                    cores (mma.sync m16n8k16, float32 accumulators, each
//                    16-deep tile's sum added in float64), the TPU
//                    kernel's _dot with preferred_element_type=f32.
//                    A 16 x 16 bf16 tile is 512 bytes, 16 a lane, like a
//                    16 x 8 float32 tile, so the weight ring and the shared
//                    memory carve are the same in every mode.
//
// Per-layer weight layout for biases and LayerNorm (float32, the
// packed.layers row of decoding/fused_greedy.py::pack_decoder_weights):
//   wqkv [3E, E] (q rows pre-scaled by 1/sqrt(dh))   bqkv [3E]
//   wo, xwq (pre-scaled), xwo [E, E] with bo, xbq, xbo [E]
//   w1 [F, E] b1 [F];  w2 [E, F] b2 [E];  ln [6, E] (norm1-3 gamma, beta)
// The fragment-packed copies of the six matrices per layer, then the
// vocabulary [V, E], are in `frag` (FragOffsets).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define ACD_NT 256              // threads per block
#define ACD_NW (ACD_NT / 32)    // warps per block
#define ACD_CMAX 16             // most blocks in a cluster
#define ACD_RMAX 32             // most rows in a tile (4 mma N tiles)
#define ACD_KMAX 8              // most beams
#define ACD_MASKED (-1e30f)     // masked attention score (the TPU kernel's fill)
#define ACD_NEG (-3.0e38f)      // the TPU kernel's stand-in for float32 min
#define ACD_PHASES 32           // trace slots a step (decoding/fused_greedy.py)
#define ACD_STAGES 8            // weight tiles in flight a warp (512 bytes each)
#define ACD_CACHE_BF16 1        // DecodeArgs.mode bits (decoding/fused_greedy.py)
#define ACD_WEIGHTS_BF16 2

typedef __nv_bfloat16 bf16;

// Mirrored by decoding/fused_greedy.py::DecodeArgs (ctypes).
struct DecodeArgs {
  const void* emb;       // [V, E] float32, or bf16 with ACD_WEIGHTS_BF16
  const float* pe;       // [max_pos, E]
  const float* layers;   // [nl, P] biases and LayerNorm (and the plain weights)
  const void* frag;      // fragment-packed matrices (FragOffsets), f32 or bf16
  const void* memkv;     // [nl, 2, B, S, E] float32, or bf16 with ACD_CACHE_BF16
  const unsigned char* mem_valid;  // [B, S]
  void* cache;           // self K/V [nl, 2, tiles * R, L, E], as memkv
  int* out_seq;          // greedy [B, L]; beam [B, K, L]
  float* out_score;      // beam [B, K]
  long long* clocks;     // optional phase trace [L][ACD_PHASES] (ns), or null
  int B, S, L, E, H, F, V, nl, K, ns, R, C, tiles, bos, eos, pad, mode;
  float sqrt_e;
};

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

__host__ __device__ __forceinline__ int acd_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// 16-byte units of one fragment-packed [N, K] matrix: N to 16 and K to kw
// (8 float32 values or 16 bf16 ones a tile's row), zero-padded, 32 units
// (512 bytes) a tile.
__host__ __device__ __forceinline__ long frag_units(int N, int K, int kw) {
  return (long)(acd_up(N, 16) / 16) * (acd_up(K, kw) / kw) * 32;
}

// decoding/fused_greedy.py::frag_offsets mirrors this (there in elements
// of the packed dtype: 4 float32 or 8 bf16 values a unit).
struct FragOffsets {
  long wqkv, wo, xwq, xwo, w1, w2, size;  // per layer
};

__host__ __device__ inline FragOffsets frag_offsets(int E, int F, int kw) {
  FragOffsets o;
  long p = 0;
  o.wqkv = p; p += frag_units(3 * E, E, kw);
  o.wo = p;   p += frag_units(E, E, kw);
  o.xwq = p;  p += frag_units(E, E, kw);
  o.xwo = p;  p += frag_units(E, E, kw);
  o.w1 = p;   p += frag_units(F, E, kw);
  o.w2 = p;   p += frag_units(E, F, kw);
  o.size = p;
  return o;
}

// ---------------------------------------------------------------- smem --

// Shared-memory work area of one block; decode_smem_bytes and
// decoding/fused_greedy.py::smem_bytes mirror its size.
struct Smem {
  int Rp, ldE, ldF, ldV, Tmax;
  float4* rings;   // [NW][STAGES][32] each warp's weight tiles in flight
  float* x;        // [Rp][ldE] hidden state (the same in every block)
  float* tmp;      // [Rp][ldE] sublayer output
  float* big;      // q [Rp][ldE] and ctx [Rp][ldE]; or hid [Rp][ldF]; or logits [Rp][ldV]
  float* q;
  float* ctx;
  float* hid;
  float* logits;
  double* red;     // [NW][16][Rp] split-K partials
  float* scores;   // [NW][Tmax] attention probabilities, a warp's
  float* xa;       // [CMAX][Rp][2] pick partials: (value, id) or (max, sum exp)
  float* xb;       // [CMAX][Rp][2] beam candidates (value, flat index)
  float* row_m;    // [Rp] beam: row max, then log-sum-exp in row_l
  float* row_l;
  int* word;       // [Rp] fed tokens
  int* flag;       // [Rp] greedy: finished
  unsigned char* valid;      // [Rp][L] fed token is not <pad>
  unsigned char* anc;        // [Rp][L] beam slot holding position j's K/V
  unsigned char* valid_tmp;  // [Rp][L]
  unsigned char* anc_tmp;    // [Rp][L]
  // beam search state, indexed s * K + k
  float* topk_lp;
  float* new_lp;
  float* done_score;
  int* prev_beam;
  int* new_word;
  int* done_count;  // [Rp] per sample
  int* stopped;     // [Rp] per sample
  int* seq;         // [Rp][L]
  int* seq_tmp;
  int* done_seq;
};

__host__ __device__ inline int vocab_tile_cols(int V, int C) {
  const int mt = (V + 15) / 16;
  return (mt + C - 1) / C * 16;
}

__host__ __device__ inline long carve_smem(char* base, Smem* sm, int R, int E,
                                           int F, int V, int L, int S, int C,
                                           bool beam) {
  Smem s;
  s.Rp = acd_up(R, 8);
  s.ldE = acd_up(E, 8) + 4;
  s.ldF = acd_up(F, 8) + 4;
  s.ldV = vocab_tile_cols(V, C) + 4;
  s.Tmax = acd_up(L > S ? L : S, 4);
  int bigw = 2 * s.ldE;
  if (s.ldF > bigw) bigw = s.ldF;
  if (s.ldV > bigw) bigw = s.ldV;
  long p = 0;
  auto take = [&](long nbytes) {
    char* ptr = base + p;
    p += (nbytes + 15) / 16 * 16;
    return ptr;
  };
  const int Rp = s.Rp;
  s.rings = (float4*)take(16L * ACD_NW * ACD_STAGES * 32);
  s.x = (float*)take(4L * Rp * s.ldE);
  s.tmp = (float*)take(4L * Rp * s.ldE);
  s.big = (float*)take(4L * Rp * bigw);
  s.q = s.big;
  s.ctx = s.big + (long)Rp * s.ldE;
  s.hid = s.big;
  s.logits = s.big;
  s.red = (double*)take(8L * ACD_NW * 16 * Rp);
  s.scores = (float*)take(4L * ACD_NW * s.Tmax);
  s.xa = (float*)take(4L * ACD_CMAX * Rp * 2);
  s.xb = (float*)take(4L * ACD_CMAX * Rp * 2);
  s.row_m = (float*)take(4L * Rp);
  s.row_l = (float*)take(4L * Rp);
  s.word = (int*)take(4L * Rp);
  s.flag = (int*)take(4L * Rp);
  s.valid = (unsigned char*)take((long)Rp * L);
  s.anc = (unsigned char*)take((long)Rp * L);
  s.valid_tmp = s.anc_tmp = nullptr;
  s.topk_lp = s.new_lp = s.done_score = nullptr;
  s.prev_beam = s.new_word = s.done_count = s.stopped = nullptr;
  s.seq = s.seq_tmp = s.done_seq = nullptr;
  if (beam) {
    s.valid_tmp = (unsigned char*)take((long)Rp * L);
    s.anc_tmp = (unsigned char*)take((long)Rp * L);
    s.topk_lp = (float*)take(4L * Rp);
    s.new_lp = (float*)take(4L * Rp);
    s.done_score = (float*)take(4L * Rp);
    s.prev_beam = (int*)take(4L * Rp);
    s.new_word = (int*)take(4L * Rp);
    s.done_count = (int*)take(4L * Rp);
    s.stopped = (int*)take(4L * Rp);
    s.seq = (int*)take(4L * Rp * L);
    s.seq_tmp = (int*)take(4L * Rp * L);
    s.done_seq = (int*)take(4L * Rp * L);
  }
  if (sm) *sm = s;
  return p;
}

__host__ inline long decode_smem_bytes(const DecodeArgs& a, bool beam) {
  return carve_smem(nullptr, nullptr, a.R, a.E, a.F, a.V, a.L, a.S, a.C, beam);
}

// ------------------------------------------------------------ reductions --

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
// index (lax.top_k / torch.argmax tie order).
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

// A lane's sorted list of its ACD_KMAX best (value, index) pairs: values
// descending, equal values in the order they arrived.  Candidates arrive
// in ascending index, so ties keep the lower index first.
__device__ __forceinline__ void topk_insert(float (&lv)[ACD_KMAX],
                                            int (&li)[ACD_KMAX], float v,
                                            int f) {
  if (!(v > lv[ACD_KMAX - 1])) return;
  bool placed = false;
#pragma unroll
  for (int i = ACD_KMAX - 1; i >= 0; --i) {
    if (!placed) {
      if (i > 0 && v > lv[i - 1]) {
        lv[i] = lv[i - 1];
        li[i] = li[i - 1];
      } else {
        lv[i] = v;
        li[i] = f;
        placed = true;
      }
    }
  }
}

__device__ __forceinline__ void topk_pop(float (&lv)[ACD_KMAX],
                                         int (&li)[ACD_KMAX]) {
#pragma unroll
  for (int i = 0; i < ACD_KMAX - 1; ++i) {
    lv[i] = lv[i + 1];
    li[i] = li[i + 1];
  }
  lv[ACD_KMAX - 1] = -INFINITY;
  li[ACD_KMAX - 1] = 0x7fffffff;
}

// The first n entries of the warp's merged order: each lane holds a sorted
// list; n rounds of a warp arg-max over the heads, the winner pops.  Lane
// 0 gets emit(sel, value, index) for each pick.
template <class Emit>
__device__ __forceinline__ void warp_merge_lists(float (&lv)[ACD_KMAX],
                                                 int (&li)[ACD_KMAX], int n,
                                                 Emit emit) {
  const int lane = threadIdx.x & 31;
  for (int sel = 0; sel < n; ++sel) {
    float v = lv[0];
    int i = li[0];
    warp_argmax(v, i);
    if (li[0] == i && i != 0x7fffffff) topk_pop(lv, li);
    if (lane == 0) emit(sel, v, i);
  }
  __syncwarp();
}

// ------------------------------------------------------- tensor cores --

// D (8 x 8, f64) += A (8 x 4) B (4 x 8) on the FP64 tensor cores.
// Fragments of m8n8k4: a0 (g, t), b0 (k = t, n = g), c0/c1 (g, 2t / 2t + 1);
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// D (16 x 8, f32) += A (16 x 16, bf16) B (16 x 8, bf16) on the bf16
// tensor cores.  Fragments of m16n8k16: a 32-bit register holds two bf16
// values, the lower column in the low half; A: a0 (g, 2t..2t+1), a1
// (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..) -- the 16 bytes a
// lane of a tile packed by fused_greedy.py::frag_pack_bf16; B: b0 (k =
// 2t..2t+1, n = g), b1 (k = 2t + 8.., n = g); c0..c3 (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void bmma(float (&c)[4], const float4 a,
                                     unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
        "r"(__float_as_uint(a.z)), "r"(__float_as_uint(a.w)), "r"(b0),
        "r"(b1));
}

// Two float32 values rounded (to nearest even) into one bf16 pair.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Four consecutive K/V values from global memory through L2 (the caches
// are written by this kernel), widened to float32; and one value.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float ld1(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float ld1(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// ------------------------------------------------------ weight stream --
//
// A step runs P = 6 * nl + 1 products in a fixed order (per layer wqkv, wo,
// xwq, xwo, w1, w2; then the vocabulary).  Within a product, warp w of a
// block takes items w, w + NW, ... (an item: one m-tile and a range of
// k-tiles), so each warp knows the whole sequence of weight tiles it will
// use, step after step.  It streams them through its own ring of
// ACD_STAGES tiles in shared memory with cp.async, issuing tile i +
// ACD_STAGES as it takes tile i: the loads run ahead across the phase
// boundaries, the attention phases and the cluster syncs, since no weight
// depends on an activation.
//
// Code size matters as much as the arithmetic here: a step walks through
// all of the kernel's code, and a kernel larger than the SM's instruction
// cache fetches its instructions from L2 in every phase.  So the product
// and the attention are each one function, called from every phase
// (__noinline__), not inlined at each call site.

// What a product needs of DecodeArgs.
struct GemmArgs {
  const float4* frag;  // in 16-byte units
  int E, F, V, nl, C;
  int kw;              // a tile's depth: 8 (float32) or 16 (bf16)
};

// One product's share of this block.
struct GemmShape {
  const float4* W;  // fragment-packed [Mt][Kt][32 lanes][16 bytes]
  int N, Kt, mt0, nm, ksplit, items;
};

__device__ __forceinline__ GemmShape gemm_shape(const GemmArgs& a, int rank,
                                                int p) {
  const FragOffsets fo = frag_offsets(a.E, a.F, a.kw);
  const int E = a.E, F = a.F;
  int N = a.V, Kd = E;
  long off = (long)a.nl * fo.size;
  if (p < 6 * a.nl) {
    const int i = p / 6, w = p - 6 * i;
    off = (long)i * fo.size;
    switch (w) {
      case 0: N = 3 * E; off += fo.wqkv; break;
      case 1: N = E; off += fo.wo; break;
      case 2: N = E; off += fo.xwq; break;
      case 3: N = E; off += fo.xwo; break;
      case 4: N = F; off += fo.w1; break;
      default: N = E; Kd = F; off += fo.w2; break;
    }
  }
  GemmShape g;
  const int Mt = (N + 15) / 16;
  g.W = a.frag + off;
  g.N = N;
  g.Kt = (Kd + a.kw - 1) / a.kw;
  g.mt0 = rank * Mt / a.C;
  g.nm = (rank + 1) * Mt / a.C - g.mt0;
  int ks = g.nm > 0 ? ACD_NW / g.nm : 1;
  if (ks < 1) ks = 1;
  if (ks > g.Kt) ks = g.Kt;
  g.ksplit = ks;
  g.items = g.nm > 0 ? g.nm * ks : 0;
  return g;
}

// 16-byte asynchronous copy global -> shared (L2 only), one group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
  asm volatile("cp.async.commit_group;\n" ::);
}

struct WStream {
  float4* ring;        // this warp's [ACD_STAGES][32] tiles
  const float4* src;   // this lane's part of the next tile to issue
  int p, it, left;     // its product and item; tiles left in the item
  unsigned issued, used;
  int empty;           // this warp owns no tile of any product
};

// Point the issue cursor at item `it` of product `p`, or at the first item
// of a later product that has one for this warp (wrapping into the next
// step).
__device__ __forceinline__ void ws_seek(const GemmArgs& a, int rank,
                                        WStream& ws) {
  const int P = 6 * a.nl + 1, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = 0; n <= P; ++n) {
    const GemmShape g = gemm_shape(a, rank, ws.p);
    if (ws.it < g.items) {
      const int m = ws.it / g.ksplit, s = ws.it - m * g.ksplit;
      const int k0 = s * g.Kt / g.ksplit, k1 = (s + 1) * g.Kt / g.ksplit;
      ws.src = g.W + ((long)(g.mt0 + m) * g.Kt + k0) * 32 + lane;
      ws.left = k1 - k0;
      return;
    }
    ws.p = ws.p + 1 == P ? 0 : ws.p + 1;
    ws.it = warp;
  }
  ws.empty = 1;
}

__device__ __forceinline__ void ws_issue(const GemmArgs& a, int rank,
                                         WStream& ws) {
  if (ws.empty) return;
  const int lane = threadIdx.x & 31;
  cp_async16(ws.ring + (ws.issued % ACD_STAGES) * 32 + lane, ws.src);
  ++ws.issued;
  ws.src += 32;
  if (--ws.left == 0) {
    ws.it += ACD_NW;
    ws_seek(a, rank, ws);
  }
}

// Start the warp's stream at step 0's first product and fill its ring.
__device__ __noinline__ void ws_start(const GemmArgs a, int rank, WStream& out,
                                      float4* rings) {
  WStream ws;
  const int warp = threadIdx.x >> 5;
  ws.ring = rings + warp * ACD_STAGES * 32;
  ws.p = 0;
  ws.it = warp;
  ws.issued = ws.used = 0;
  ws.empty = 0;
  ws_seek(a, rank, ws);
  for (int i = 0; i < ACD_STAGES; ++i) ws_issue(a, rank, ws);
  out = ws;
}

// The warp's next tile; its slot is refilled with the tile ACD_STAGES
// ahead once it has been read.
__device__ __forceinline__ float4 ws_take(const GemmArgs& a, int rank,
                                          WStream& ws) {
  const int lane = threadIdx.x & 31;
  asm volatile("cp.async.wait_group %0;\n" :: "n"(ACD_STAGES - 1));
  const float4 w = ws.ring[(ws.used % ACD_STAGES) * 32 + lane];
  ++ws.used;
  asm volatile("" ::: "memory");  // the read precedes the refill
  ws_issue(a, rank, ws);
  return w;
}

// Where a product's outputs go.
enum { EPI_QKV = 0, EPI_BIAS = 1, EPI_RELU = 2, EPI_LOGITS = 3 };

struct Epi {
  int mode;
  float* out;          // [Rp][ld] shared
  int ld;
  const float* bias;
  void* kc;            // EPI_QKV: this layer's self K and V caches
  void* vc;
  long cache0;         // offset of the tile's row 0 at position t
  long LE;             // cache row stride (L * E)
  int E;
  int cache_bf16;      // the caches are bf16 (a K/V value rounded twice,
                       // to float32 and then to bf16, as on the TPU)
};

// out = y + bias (rounded once); EPI_QKV sends q to out and K, V to the
// caches; EPI_LOGITS keeps the block's slice at column n - c0.
__device__ __forceinline__ void epi_store(const Epi& e, int n, int r, double y,
                                          int c0) {
  switch (e.mode) {
    case EPI_QKV: {
      const float v = (float)(y + __ldg(e.bias + n));
      if (n < e.E) {
        e.out[r * e.ld + n] = v;
      } else {
        void* c = n < 2 * e.E ? e.kc : e.vc;
        const long o = e.cache0 + r * e.LE + (n % e.E);
        if (e.cache_bf16)
          __stcg(reinterpret_cast<unsigned short*>(c) + o,
                 __bfloat16_as_ushort(__float2bfloat16_rn(v)));
        else
          __stcg(reinterpret_cast<float*>(c) + o, v);
      }
      break;
    }
    case EPI_BIAS:
      e.out[r * e.ld + n] = (float)(y + __ldg(e.bias + n));
      break;
    case EPI_RELU:
      e.out[r * e.ld + n] = fmaxf((float)(y + __ldg(e.bias + n)), 0.f);
      break;
    default:
      e.out[r * e.ld + n - c0] = (float)y;
  }
}

// acc[h][j] += the k-half h of one packed 16 x 8 tile (this lane's (g, t),
// (g + 8, t) for h = 0; (g, t + 4), (g + 8, t + 4) for h = 1) times
// X[8j:8j+8, k + 4h : k + 4h + 4]^T, for j < NJ.  A tile is 2 x 2 m8n8k4
// products; each of the four accumulates into its own registers, so none
// waits for another.  Every product of two float32 values is exact in
// float64 and the sums are float64, so a dot product is rounded once, to
// float32, at the end.  acc[h][j] = (g, 2t), (g, 2t+1), (g + 8, 2t),
// (g + 8, 2t+1).
template <int NJ>
__device__ __forceinline__ void mma_tile(double (&acc)[2][NJ][4],
                                         const float4 w, const float* X,
                                         int ldx, int k, int g, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float* xp = X + (j * 8 + g) * ldx + k + t;
    const double b0 = xp[0], b1 = xp[4];
    dmma(acc[0][j][0], acc[0][j][1], w.x, b0);
    dmma(acc[0][j][2], acc[0][j][3], w.y, b0);
    dmma(acc[1][j][0], acc[1][j][1], w.z, b1);
    dmma(acc[1][j][2], acc[1][j][3], w.w, b1);
  }
}

// This warp's items for NJ row tiles: even and odd k-tiles go to two sets
// of accumulators (with the k-halves apart, 8 * NJ independent products
// in flight), added in a fixed order at the end.
template <int NJ>
__device__ __forceinline__ void gemm_items(const GemmArgs& a, int rank,
                                           WStream& ws, const GemmShape& g,
                                           const float* X, int ldx, int R,
                                           int Rp, double* red, const Epi& e,
                                           int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  for (int it = warp; it < g.items; it += ACD_NW) {
    const int m = it / g.ksplit, s = it - m * g.ksplit;
    const int k0 = s * g.Kt / g.ksplit, k1 = (s + 1) * g.Kt / g.ksplit;
    double ev[2][NJ][4], od[2][NJ][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) ev[h][j][i] = od[h][j][i] = 0.0;
    int kt = k0;
    for (; kt + 2 <= k1; kt += 2) {
      const float4 w0 = ws_take(a, rank, ws);
      const float4 w1 = ws_take(a, rank, ws);
      mma_tile<NJ>(ev, w0, X, ldx, kt * 8, gq, t);
      mma_tile<NJ>(od, w1, X, ldx, kt * 8 + 8, gq, t);
    }
    if (kt < k1) mma_tile<NJ>(ev, ws_take(a, rank, ws), X, ldx, kt * 8, gq, t);
    const int n0 = (g.mt0 + m) * 16 + gq;
    double* rp = red + (long)it * 16 * Rp;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r0 = j * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double y =
            (ev[0][j][i] + ev[1][j][i]) + (od[0][j][i] + od[1][j][i]);
        const int n = n0 + (i >> 1) * 8, r = r0 + (i & 1);
        if (g.ksplit > 1)
          rp[(gq + (i >> 1) * 8) * Rp + r] = y;
        else if (n < g.N && r < R)
          epi_store(e, n, r, y, c0);
      }
    }
  }
}

// acc[j] += one packed 16 x 16 bf16 tile times X[8j:8j+8, k:k+16]^T,
// each X value rounded to bf16 as it is read (this lane's b0 from
// columns k + 2t, k + 2t + 1 of row 8j + g, b1 from k + 2t + 8, ...).
// Each tile's 16 products are summed by one mma from zero, in float32;
// the tiles' sums are added in float64, as the plain version and the
// float32 mode sum, rather than through the tensor cores' own float32
// accumulation across all K / 16 tiles.
template <int NJ>
__device__ __forceinline__ void mma_tile_bf16(double (&acc)[NJ][4],
                                              const float4 w, const float* X,
                                              int ldx, int k, int g, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float* xp = X + (j * 8 + g) * ldx + k + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(xp);
    const float2 hi = *reinterpret_cast<const float2*>(xp + 8);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    bmma(c, w, pack_bf16x2(lo.x, lo.y), pack_bf16x2(hi.x, hi.y));
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += c[i];
  }
}

// gemm_items for bf16 weights: a 16 x 16 tile a take; outputs as
// gemm_items.
template <int NJ>
__device__ __forceinline__ void gemm_items_bf16(const GemmArgs& a, int rank,
                                                WStream& ws,
                                                const GemmShape& g,
                                                const float* X, int ldx,
                                                int R, int Rp, double* red,
                                                const Epi& e, int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  for (int it = warp; it < g.items; it += ACD_NW) {
    const int m = it / g.ksplit, s = it - m * g.ksplit;
    const int k0 = s * g.Kt / g.ksplit, k1 = (s + 1) * g.Kt / g.ksplit;
    double acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0;
    for (int kt = k0; kt < k1; ++kt)
      mma_tile_bf16<NJ>(acc, ws_take(a, rank, ws), X, ldx, kt * 16, gq, t);
    const int n0 = (g.mt0 + m) * 16 + gq;
    double* rp = red + (long)it * 16 * Rp;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r0 = j * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double y = acc[j][i];
        const int n = n0 + (i >> 1) * 8, r = r0 + (i & 1);
        if (g.ksplit > 1)
          rp[(gq + (i >> 1) * 8) * Rp + r] = y;
        else if (n < g.N && r < R)
          epi_store(e, n, r, y, c0);
      }
    }
  }
}

// Y[r, n] = sum_k W[n, k] X[r, k] for this block's m-tiles of product p,
// rows r < R of X [Rp][ldx] (shared), weights from the warp's stream
// (float32 on the FP64 tensor cores, or bf16 with WB); each output to
// epi_store.  Returns the block's output columns [c0, c1).  Ends with
// __syncthreads().
template <bool WB>
__device__ __noinline__ int2 gemm_phase(const GemmArgs a, int rank,
                                        WStream& ws_state, int p,
                                        const float* X, int ldx, int R, int Rp,
                                        double* red, const Epi e) {
  WStream ws = ws_state;
  const GemmShape g = gemm_shape(a, rank, p);
  const int c0 = g.mt0 * 16;
  int c1 = (g.mt0 + g.nm) * 16;
  if (c1 > g.N) c1 = g.N;
  if (g.items > 0) {  // block-uniform
    if (WB) {
      switch ((R + 7) >> 3) {
        case 1: gemm_items_bf16<1>(a, rank, ws, g, X, ldx, R, Rp, red, e, c0); break;
        case 2: gemm_items_bf16<2>(a, rank, ws, g, X, ldx, R, Rp, red, e, c0); break;
        case 3: gemm_items_bf16<3>(a, rank, ws, g, X, ldx, R, Rp, red, e, c0); break;
        default: gemm_items_bf16<4>(a, rank, ws, g, X, ldx, R, Rp, red, e, c0); break;
      }
    } else {
      switch ((R + 7) >> 3) {
        case 1: gemm_items<1>(a, rank, ws, g, X, ldx, R, Rp, red, e, c0); break;
        case 2: gemm_items<2>(a, rank, ws, g, X, ldx, R, Rp, red, e, c0); break;
        case 3: gemm_items<3>(a, rank, ws, g, X, ldx, R, Rp, red, e, c0); break;
        default: gemm_items<4>(a, rank, ws, g, X, ldx, R, Rp, red, e, c0); break;
      }
    }
    if (g.ksplit > 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < g.nm * 16 * R; i += ACD_NT) {
        const int m = i / (16 * R), rem = i - m * 16 * R;
        const int col = rem / R, r = rem - col * R;
        double y = 0.0;
        for (int s = 0; s < g.ksplit; ++s)
          y += red[((long)(m * g.ksplit + s) * 16 + col) * Rp + r];
        const int n = (g.mt0 + m) * 16 + col;
        if (n < g.N) epi_store(e, n, r, y, c0);
      }
    }
  }
  __syncthreads();
  ws_state = ws;
  return make_int2(c0, c1);
}

// Copy columns [c0, c1) of rows r < R of buf (this block's output; c0 and
// c1 - c0 multiples of 4) to the same place in every other block of the
// cluster, a float4 a store.
__device__ __forceinline__ void broadcast_cols(cg::cluster_group& cl,
                                               float* buf, int ld, int c0,
                                               int c1, int R, int C,
                                               int rank) {
  const int n4 = (c1 - c0) >> 2;
  if (n4 <= 0) return;
  const int per = R * n4;
  for (int i = threadIdx.x; i < per * (C - 1); i += ACD_NT) {
    const int qi = i / per, e = i - qi * per;
    const int q = qi + (qi >= rank ? 1 : 0);
    const int r = e / n4, c = c0 + 4 * (e - r * n4);
    const float4 v = *reinterpret_cast<const float4*>(buf + r * ld + c);
    *reinterpret_cast<float4*>(cl.map_shared_rank(buf, q) + r * ld + c) = v;
  }
}

// ----------------------------------------------------------- row pieces --

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x[r] = LayerNorm(x[r] + y[r]) * gamma + beta, eps 1e-5, two-pass
// variance; a warp a row.  The residual sum is float32 (as stored); mean,
// variance and the normalisation are float64, rounded once.  Ends with
// __syncthreads().
__device__ __noinline__ void add_layernorm(float* x, const float* y, int ld,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           int R, int E) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += ACD_NW) {
    float* xr = x + r * ld;
    const float* yr = y + r * ld;
    double s = 0.0;
    for (int e = lane; e < E; e += 32) {
      xr[e] += yr[e];
      s += xr[e];
    }
    const double mean = warp_sum_d(s) / E;
    double ss = 0.0;
    for (int e = lane; e < E; e += 32) {
      const double d = xr[e] - mean;
      ss += d * d;
    }
    const double rs = 1.0 / sqrt(warp_sum_d(ss) / E + 1e-5);
    for (int e = lane; e < E; e += 32)
      xr[e] = (float)((xr[e] - mean) * rs * __ldg(gamma + e) + __ldg(beta + e));
  }
  __syncthreads();
}

// x[r] = emb[word[r]] * sqrt_e + pe[t], from the bf16 table with WB
template <bool WB>
__device__ __forceinline__ void embed_rows(const void* __restrict__ emb,
                                           const float* __restrict__ pe,
                                           const int* word, float* x, int ld,
                                           int R, int E, int t, float sqrt_e) {
  for (int re = threadIdx.x; re < R * E; re += ACD_NT) {
    const int r = re / E, e = re - r * E;
    const long i = (long)word[r] * E + e;
    const float w =
        WB ? __bfloat162float(__ushort_as_bfloat16(
                 __ldg(reinterpret_cast<const unsigned short*>(emb) + i)))
           : __ldg(reinterpret_cast<const float*>(emb) + i);
    // two roundings, as the plain version (no fused multiply-add)
    x[r * ld + e] = __fadd_rn(__fmul_rn(w, sqrt_e), __ldg(pe + (long)t * E + e));
  }
  __syncthreads();
}

// One warp: attention of one query (q, dh floats in shared memory) over T
// keys.  Key j's row of this head is kb + anc[j] * slot + j * E (anc null:
// kb + j * E), its value row the same from vb; valid[j] != 0 attends
// (shared or global memory).  Masked keys score ACD_MASKED, so a row whose
// keys are all masked attends uniformly, as on the TPU.  The context goes
// to out[0:dh] (shared).  Rows are read through L2 (__ldcg): the self
// caches are written by this kernel.  K/V are CT (float32, or bf16 read
// widened).  Sums are float64, scores and probabilities rounded to
// float32 as stored.  With dh a multiple of 4, P lanes share a key's dot
// product (four values a load, 32/P keys a pass) and the context splits
// the keys over G lane groups, each lane four features; so a lane keeps
// several independent L2 loads in flight.
template <typename CT>
__device__ __noinline__ void attend_warp(const float* q, int dh, int T,
                                         const CT* kb, const CT* vb,
                                         const unsigned char* anc, long slot,
                                         int E, const unsigned char* valid,
                                         float* sc, float* out) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  if ((dh & 3) != 0) {  // scalar fallback: a lane a key, a lane a feature
    for (int j = lane; j < T; j += 32) {
      const CT* kr = kb + (anc ? anc[j] * slot : 0L) + (long)j * E;
      double s = 0.0;
      for (int d = 0; d < dh; ++d) s += (double)q[d] * ld1(kr + d);
      const float sf = valid[j] ? (float)s : ACD_MASKED;
      sc[j] = sf;
      m = fmaxf(m, sf);
    }
  } else {
    const int q4 = dh >> 2;
    const int P = (q4 & 3) == 0 ? 4 : ((q4 & 1) == 0 ? 2 : 1);
    const int KP = 32 / P, sub = lane % P, kl = lane / P, per = q4 / P;
    const float4* qv = reinterpret_cast<const float4*>(q) + sub;
#pragma unroll 2
    for (int j0 = 0; j0 < T; j0 += KP) {
      const int j = j0 + kl;
      double s = 0.0;
      if (j < T) {
        const CT* kr = kb + (anc ? anc[j] * slot : 0L) + (long)j * E + 4 * sub;
#pragma unroll 4
        for (int i = 0; i < per; ++i) {
          const float4 kv = ld4(kr + 4 * P * i);
          const float4 x = qv[P * i];
          s += (double)x.x * kv.x + (double)x.y * kv.y + (double)x.z * kv.z +
               (double)x.w * kv.w;
        }
      }
      for (int o = P >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (j < T) {
        const float sf = valid[j] ? (float)s : ACD_MASKED;
        if (sub == 0) sc[j] = sf;
        m = fmaxf(m, sf);
      }
    }
  }
  m = warp_max(m);
  __syncwarp();
  double sum = 0.0;
  for (int j = lane; j < T; j += 32) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    sum += e;
  }
  sum = warp_sum_d(sum);
  for (int j = lane; j < T; j += 32) sc[j] = (float)(sc[j] / sum);
  __syncwarp();
  if ((dh & 3) != 0) {
    for (int d = lane; d < dh; d += 32) {
      double acc = 0.0;
      for (int j = 0; j < T; ++j)
        acc += (double)sc[j] *
               ld1(vb + (anc ? anc[j] * slot : 0L) + (long)j * E + d);
      out[d] = (float)acc;
    }
  } else {
    const int q4 = dh >> 2;
    const int G = (q4 <= 32 && 32 % q4 == 0) ? 32 / q4 : 1;
    const int g = lane / (32 / G), d4 = lane % (32 / G);
    for (int c4 = d4; c4 < q4; c4 += 32 / G) {
      double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 8
      for (int j = g; j < T; j += G) {
        const double p = sc[j];
        const float4 v =
            ld4(vb + (anc ? anc[j] * slot : 0L) + (long)j * E + 4 * c4);
        acc[0] += p * v.x;
        acc[1] += p * v.y;
        acc[2] += p * v.z;
        acc[3] += p * v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        for (int o = 32 / G; o < 32; o <<= 1)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) out[4 * c4 + i] = (float)acc[i];
      }
    }
  }
  __syncwarp();
}

// ------------------------------------------------------- the layer stack --

// Tile geometry and where its rows live.
struct TileCtx {
  int rank, C;
  int R, Rp, ns, K;        // rows, padded rows, samples, rows per sample
  long row0;               // first physical cache row of the tile
  int sample0;             // first sample of the tile
  long rows_total;         // physical cache rows
};

// Write v to buf[off] in every block of the cluster (small exchanges).
__device__ __forceinline__ void push_all(cg::cluster_group& cl, float* buf,
                                         long off, float v, int C) {
  for (int q = 0; q < C; ++q) cl.map_shared_rank(buf, q)[off] = v;
}

// Phase trace: block 0's thread 0 records the global timer (ns) at slot
// ph of step t when the caller passed a clocks buffer.  Slot 0 is the
// step's start; per layer i, slots 10i + 1..10 follow the qkv product,
// the syncs of qkv, self attention, wo, xq and cross attention, the xwo
// product, and the syncs of xwo, w1 and w2; the kernels add slots after
// the vocabulary product, their pick syncs and the step's end.
__device__ __forceinline__ void stamp(const DecodeArgs& a, int t, int ph) {
  if (a.clocks != nullptr && blockIdx.x == 0 && threadIdx.x == 0 &&
      ph < ACD_PHASES) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    a.clocks[t * ACD_PHASES + ph] = (long long)ns;
  }
}

// One warp's attention output for (row r, head h), already in this block's
// ctx at off: copied to every other block's, a float4 a store.
__device__ __forceinline__ void share_head(cg::cluster_group& cl, float* ctx,
                                           long off, int dh, int C, int rank) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if ((dh & 3) == 0) {
    const int n4 = dh >> 2;
    for (int i = lane; i < n4 * (C - 1); i += 32) {
      const int qi = i / n4, c = 4 * (i - qi * n4);
      const int q = qi + (qi >= rank ? 1 : 0);
      const float4 v = *reinterpret_cast<const float4*>(ctx + off + c);
      *reinterpret_cast<float4*>(cl.map_shared_rank(ctx, q) + off + c) = v;
    }
  } else {
    for (int i = lane; i < dh * (C - 1); i += 32) {
      const int qi = i / dh, c = i - qi * dh;
      cl.map_shared_rank(ctx, qi + (qi >= rank ? 1 : 0))[off + c] = ctx[off + c];
    }
  }
}

template <bool WB>
__device__ __forceinline__ GemmArgs gemm_args(const DecodeArgs& a) {
  GemmArgs g;
  g.frag = reinterpret_cast<const float4*>(a.frag);
  g.E = a.E;
  g.F = a.F;
  g.V = a.V;
  g.nl = a.nl;
  g.C = a.C;
  g.kw = WB ? 16 : 8;
  return g;
}

__device__ __forceinline__ Epi make_epi(int mode, float* out, int ld,
                                        const float* bias) {
  Epi e;
  e.mode = mode;
  e.out = out;
  e.ld = ld;
  e.bias = bias;
  e.kc = e.vc = nullptr;
  e.cache0 = e.LE = 0;
  e.E = 0;
  e.cache_bf16 = 0;
  return e;
}

// One pass of the tile's hidden state x (R rows at position t) through
// all decoder layers, ending with the last LayerNorm.  Row r's K/V at
// positions j < t are at beam slot anc[r][j] of its sample; this step's
// are written at its own slot.  Each product's output columns go to
// every block before the cluster syncs.  CT: the K/V storage type; WB:
// bf16 weights.
template <typename CT, bool WB>
__device__ __forceinline__ void decoder_layers(const DecodeArgs& a,
                                               cg::cluster_group& cl,
                                               const TileCtx& tc,
                                               const Smem& sm, WStream& ws,
                                               int t) {
  const int E = a.E, F = a.F, H = a.H, L = a.L, S = a.S;
  const int dh = E / H;
  const LayerOffsets off = layer_offsets(E, F);
  const GemmArgs ga = gemm_args<WB>(a);
  const int warp = threadIdx.x >> 5;
  const int R = tc.R, Rp = tc.Rp, C = tc.C, rank = tc.rank;
  const long LE = (long)L * E;
  float* sc = sm.scores + warp * sm.Tmax;
  int2 cols;
  for (int i = 0; i < a.nl; ++i) {
    const float* w = a.layers + (long)i * off.size;
    CT* kc = reinterpret_cast<CT*>(a.cache) + (long)(2 * i) * tc.rows_total * LE;
    CT* vc = reinterpret_cast<CT*>(a.cache) +
             (long)(2 * i + 1) * tc.rows_total * LE;
    if (i > 0)
      add_layernorm(sm.x, sm.tmp, sm.ldE, w - off.size + off.ln + 4 * E,
                    w - off.size + off.ln + 5 * E, R, E);
    // 1. q to every block; this step's K and V to the global caches
    Epi e = make_epi(EPI_QKV, sm.q, sm.ldE, w + off.bqkv);
    e.kc = kc;
    e.vc = vc;
    e.cache0 = tc.row0 * LE + (long)t * E;
    e.LE = LE;
    e.E = E;
    e.cache_bf16 = sizeof(CT) == 2;
    cols = gemm_phase<WB>(ga, rank, ws, 6 * i, sm.x, sm.ldE, R, Rp, sm.red, e);
    stamp(a, t, 10 * i + 1);
    broadcast_cols(cl, sm.q, sm.ldE, cols.x, cols.y < E ? cols.y : E, R, C,
                   rank);
    cl.sync();
    stamp(a, t, 10 * i + 2);
    // 2. self attention, a warp a (row, head)
    for (int u = rank * ACD_NW + warp; u < R * H; u += C * ACD_NW) {
      const int r = u / H, h = u - r * H;
      const long o = (long)r * sm.ldE + h * dh;
      const long base = (tc.row0 + (r / tc.K) * tc.K) * LE + h * dh;
      attend_warp<CT>(sm.q + o, dh, t + 1, kc + base, vc + base, sm.anc + r * L,
                  LE, E, sm.valid + r * L, sc, sm.ctx + o);
      share_head(cl, sm.ctx, o, dh, C, rank);
    }
    cl.sync();
    stamp(a, t, 10 * i + 3);
    // 3. output projection
    cols = gemm_phase<WB>(ga, rank, ws, 6 * i + 1, sm.ctx, sm.ldE, R, Rp, sm.red,
                      make_epi(EPI_BIAS, sm.tmp, sm.ldE, w + off.bo));
    broadcast_cols(cl, sm.tmp, sm.ldE, cols.x, cols.y, R, C, rank);
    cl.sync();
    stamp(a, t, 10 * i + 4);
    // 4. norm1, cross-attention query
    add_layernorm(sm.x, sm.tmp, sm.ldE, w + off.ln, w + off.ln + E, R, E);
    cols = gemm_phase<WB>(ga, rank, ws, 6 * i + 2, sm.x, sm.ldE, R, Rp, sm.red,
                      make_epi(EPI_BIAS, sm.q, sm.ldE, w + off.xbq));
    broadcast_cols(cl, sm.q, sm.ldE, cols.x, cols.y, R, C, rank);
    cl.sync();
    stamp(a, t, 10 * i + 5);
    // 5. cross attention on the precomputed memory K/V
    {
      const long SE = (long)S * E;
      const CT* mk = reinterpret_cast<const CT*>(a.memkv) + (long)(2 * i) * a.B * SE;
      const CT* mv =
          reinterpret_cast<const CT*>(a.memkv) + (long)(2 * i + 1) * a.B * SE;
      for (int u = rank * ACD_NW + warp; u < R * H; u += C * ACD_NW) {
        const int r = u / H, h = u - r * H;
        int b = tc.sample0 + r / tc.K;
        if (b >= a.B) b = a.B - 1;  // masked rows read a real sample
        const long o = (long)r * sm.ldE + h * dh;
        attend_warp<CT>(sm.q + o, dh, S, mk + b * SE + h * dh, mv + b * SE + h * dh,
                    nullptr, 0, E, a.mem_valid + (long)b * S, sc, sm.ctx + o);
        share_head(cl, sm.ctx, o, dh, C, rank);
      }
    }
    cl.sync();
    stamp(a, t, 10 * i + 6);
    // 6. cross-attention output projection
    cols = gemm_phase<WB>(ga, rank, ws, 6 * i + 3, sm.ctx, sm.ldE, R, Rp, sm.red,
                      make_epi(EPI_BIAS, sm.tmp, sm.ldE, w + off.xbo));
    stamp(a, t, 10 * i + 7);
    broadcast_cols(cl, sm.tmp, sm.ldE, cols.x, cols.y, R, C, rank);
    cl.sync();
    stamp(a, t, 10 * i + 8);
    // 7. norm2, FFN up (ReLU)
    add_layernorm(sm.x, sm.tmp, sm.ldE, w + off.ln + 2 * E, w + off.ln + 3 * E,
                  R, E);
    cols = gemm_phase<WB>(ga, rank, ws, 6 * i + 4, sm.x, sm.ldE, R, Rp, sm.red,
                      make_epi(EPI_RELU, sm.hid, sm.ldF, w + off.b1));
    broadcast_cols(cl, sm.hid, sm.ldF, cols.x, cols.y, R, C, rank);
    cl.sync();
    stamp(a, t, 10 * i + 9);
    // 8. FFN down
    cols = gemm_phase<WB>(ga, rank, ws, 6 * i + 5, sm.hid, sm.ldF, R, Rp, sm.red,
                      make_epi(EPI_BIAS, sm.tmp, sm.ldE, w + off.b2));
    broadcast_cols(cl, sm.tmp, sm.ldE, cols.x, cols.y, R, C, rank);
    cl.sync();
    stamp(a, t, 10 * i + 10);
  }
  const float* wl = a.layers + (long)(a.nl - 1) * off.size;
  add_layernorm(sm.x, sm.tmp, sm.ldE, wl + off.ln + 4 * E, wl + off.ln + 5 * E,
                R, E);
}

// Tied vocabulary logits of this block's slice, rows r < R, into
// sm.logits [r][n - v0]; returns v0 and the slice width in nv.
template <bool WB>
__device__ __forceinline__ int vocab_logits(const DecodeArgs& a,
                                            const TileCtx& tc, const Smem& sm,
                                            WStream& ws, int& nv) {
  const int2 cols = gemm_phase<WB>(gemm_args<WB>(a), tc.rank, ws, 6 * a.nl, sm.x,
                               sm.ldE, tc.R, tc.Rp, sm.red,
                               make_epi(EPI_LOGITS, sm.logits, sm.ldV, nullptr));
  nv = cols.y > cols.x ? cols.y - cols.x : 0;
  return cols.x;
}

// Zero the block's shared memory (padding lanes of the product inputs must
// hold finite values), then sync the cluster so that no peer writes into
// it before that.
__device__ __forceinline__ void zero_smem(char* base, long bytes) {
  float4* p = reinterpret_cast<float4*>(base);
  for (long i = threadIdx.x; i < bytes / 16; i += ACD_NT)
    p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
}

// Launch `kernel` on tiles * C blocks in clusters of C.
__host__ inline int launch_clusters(void (*kernel)(DecodeArgs),
                                    const DecodeArgs& a, long smem,
                                    cudaStream_t stream) {
  if (a.C < 1 || a.C > ACD_CMAX || a.R < 1 || a.R > ACD_RMAX ||
      a.K < 1 || a.K > ACD_KMAX || a.tiles < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (a.C > 8) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.tiles * a.C, 1, 1);
  cfg.blockDim = dim3(ACD_NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of C blocks with `smem` bytes each can be resident at
// once (cudaOccupancyMaxActiveClusters); negative: a CUDA error.
__host__ inline int max_active_clusters(void (*kernel)(DecodeArgs), int C,
                                        long smem) {
  cudaError_t err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(ACD_NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return n;
}
