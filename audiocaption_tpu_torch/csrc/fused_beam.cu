// Whole-loop beam-K caption search for Hopper (sm_90a).
//
// Replaces the TPU kernel audiocaption_tpu/decoding/fused_beam.py
// (_make_beam_kernel :126-384, launched by _fused_beam_call :387-447).
//
// A cluster of C blocks owns a tile of ns samples with their K beams
// (R = ns * K rows, K <= 8) for all max_length steps.  Per step: the
// decoder layers of decoder_common.cuh on the R rows (each sample's memory
// K/V is read by its beams), then the pick on the split vocabulary:
//   1. each block computes its slice's logits and, per row, (max, sum of
//      exp) over the slice, pushed to every block; cluster sync;
//   2. every block merges them into each row's log-sum-exp (slice order),
//      scores its candidates (k, w in slice) as log-softmax plus the
//      running beam score (only beam 0 competes at t=0), takes a local
//      top-K per sample by (value, flat index k*V + w; ties -> lower flat
//      index, as lax.top_k) and pushes it to every block; cluster sync;
//   3. every block merges the C*K candidates per sample in the same order.
//      The global top-K is a subset of the union of the local ones, so
//      this is exactly the top-K over [K*V].
// Then, identically in every block: the parent gather of the sequences,
// the pad flags and the ancestry table (which beam slot holds each past
// position's K/V; the caches are never copied), the harvest of ended beams
// with score / (t+1) (every beam at t=L-1), the stable best-K merge of done
// beams and candidates, -1000 on ended beams.  A sample's state stops
// changing once K beams are done; the tile stops when all its samples
// have.  Samples past B are masked: stopped from the start, never written.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; beam 3, B=64,
// S=31, L=20): as the greedy kernel, the products of a step's 13 phases of
// products and 4 of attention, now on K rows a sample, plus 2 syncs for
// the pick.  The first design streamed all ~12.4 MB of float32 weights
// from L2 per sample and step on one block each, and copied the cache
// prefix at every step: 16.0 ms.  Here 5.4 ms (13 clusters of 8 blocks,
// 15 rows each); beam 5 and 8 need two waves of clusters at B=64.
//
// Modes, as the TPU kernel's: cache_bf16 (CT = bf16: memory K/V and self
// caches stored in bf16) and weights_bf16 (WB: the layer matrices, the
// tied vocabulary and the embedding in bf16, each product's activations
// rounded to bf16 and the products on the bf16 tensor cores with float32
// sums; decoder_common.cuh), in any combination: four instantiations.
#include "decoder_common.cuh"

template <typename CT, bool WB>
__global__ void __launch_bounds__(ACD_NT, 1) fused_beam_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  Smem sm;
  const long bytes = carve_smem(smem_raw, &sm, a.R, a.E, a.F, a.V, a.L, a.S,
                                a.C, true);
  zero_smem(smem_raw, bytes);
  WStream ws;

  TileCtx tc;
  tc.rank = (int)cl.block_rank();
  tc.C = a.C;
  tc.R = a.R;
  tc.Rp = sm.Rp;
  tc.ns = a.ns;
  tc.K = a.K;
  ws_start(gemm_args<WB>(a), tc.rank, ws, sm.rings);
  const int tile = blockIdx.x / a.C;
  tc.row0 = (long)tile * a.R;
  tc.sample0 = tile * a.ns;
  tc.rows_total = (long)a.tiles * a.R;
  const int R = a.R, L = a.L, K = a.K, V = a.V, ns = a.ns;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x;

  for (int i = tid; i < R * L; i += ACD_NT) {
    sm.seq[i] = a.eos;
    sm.done_seq[i] = a.eos;
  }
  for (int r = tid; r < R; r += ACD_NT) {
    sm.word[r] = a.bos;
    sm.topk_lp[r] = 0.f;
    sm.done_score[r] = ACD_NEG;
  }
  for (int s = tid; s < ns; s += ACD_NT) {
    sm.done_count[s] = 0;
    sm.stopped[s] = tc.sample0 + s >= a.B;  // masked samples
  }
  __syncthreads();
  cl.sync();

  for (int t = 0; t < L; ++t) {
    stamp(a, t, 0);
    for (int r = tid; r < R; r += ACD_NT) {
      sm.valid[r * L + t] = sm.word[r] != a.pad;
      sm.anc[r * L + t] = (unsigned char)(r % K);
    }
    embed_rows<WB>(a.emb, a.pe, sm.word, sm.x, sm.ldE, R, a.E, t, a.sqrt_e);
    decoder_layers<CT, WB>(a, cl, tc, sm, ws, t);

    // 1. the slice's logits; per row (max, sum exp) over the slice
    int nv;
    const int v0 = vocab_logits<WB>(a, tc, sm, ws, nv);
    stamp(a, t, 10 * a.nl + 1);
    for (int r = warp; r < R; r += ACD_NW) {
      const float* lr = sm.logits + r * sm.ldV;
      float m = -INFINITY;
      for (int v = lane; v < nv; v += 32) m = fmaxf(m, lr[v]);
      m = warp_max(m);
      double s = 0.0;
      if (nv > 0)
        for (int v = lane; v < nv; v += 32) s += expf(lr[v] - m);
      s = warp_sum_d(s);
      if (lane == 0) {
        const long o = ((long)tc.rank * sm.Rp + r) * 2;
        push_all(cl, sm.xa, o, m, a.C);
        push_all(cl, sm.xa, o + 1, (float)s, a.C);
      }
    }
    cl.sync();
    stamp(a, t, 10 * a.nl + 2);

    // 2. log-sum-exp per row, then the slice's top-K per sample
    for (int r = tid; r < R; r += ACD_NT) {
      float m = -INFINITY;
      for (int c = 0; c < a.C; ++c) m = fmaxf(m, sm.xa[((long)c * sm.Rp + r) * 2]);
      double s = 0.0;
      for (int c = 0; c < a.C; ++c) {
        const float* p = sm.xa + ((long)c * sm.Rp + r) * 2;
        if (p[1] > 0.f) s += (double)p[1] * exp((double)p[0] - m);
      }
      sm.row_m[r] = m;
      sm.row_l[r] = (float)log(s);
    }
    __syncthreads();
    for (int s = warp; s < ns; s += ACD_NW) {
      float lv[ACD_KMAX];
      int li[ACD_KMAX];
#pragma unroll
      for (int i = 0; i < ACD_KMAX; ++i) {
        lv[i] = -INFINITY;
        li[i] = 0x7fffffff;
      }
      for (int i = lane; i < K * nv; i += 32) {
        const int k = i / nv, w = i - k * nv, r = s * K + k;
        const float val =
            (t == 0 && k > 0)
                ? ACD_NEG
                : ((sm.logits[r * sm.ldV + w] - sm.row_m[r]) - sm.row_l[r]) +
                      sm.topk_lp[r];
        topk_insert(lv, li, val, k * V + v0 + w);
      }
      warp_merge_lists(lv, li, K, [&](int sel, float v, int f) {
        const long o = (((long)tc.rank * ns + s) * K + sel) * 2;
        push_all(cl, sm.xb, o, v, a.C);
        push_all(cl, sm.xb, o + 1, __int_as_float(f), a.C);
      });
    }
    cl.sync();
    stamp(a, t, 10 * a.nl + 3);

    // 3. merge the C local top-K lists per sample
    for (int s = warp; s < ns; s += ACD_NW) {
      float lv[ACD_KMAX];
      int li[ACD_KMAX];
#pragma unroll
      for (int i = 0; i < ACD_KMAX; ++i) {
        const bool have = lane < a.C && i < K;
        const float* p = sm.xb + (((long)lane * ns + s) * K + i) * 2;
        lv[i] = have ? p[0] : -INFINITY;
        li[i] = have ? __float_as_int(p[1]) : 0x7fffffff;
      }
      warp_merge_lists(lv, li, K, [&](int sel, float v, int f) {
        if (f < 0 || f >= K * V) f = 0;  // all-NaN row: keep indices valid
        sm.new_lp[s * K + sel] = v;
        sm.prev_beam[s * K + sel] = f / V;
        sm.new_word[s * K + sel] = f % V;
      });
    }
    __syncthreads();

    // parent gather of sequences, pad flags and ancestry (positions <= t)
    for (int c = tid; c < R * L; c += ACD_NT) {
      const int r = c / L, j = c - r * L;
      const int src = (r / K) * K + sm.prev_beam[r];
      sm.seq_tmp[c] = j < t ? sm.seq[src * L + j] : (j == t ? sm.new_word[r] : a.eos);
      sm.valid_tmp[c] = j <= t ? sm.valid[src * L + j] : 1;
      sm.anc_tmp[c] = j <= t ? sm.anc[src * L + j] : 0;
    }
    __syncthreads();
    for (int c = tid; c < R * L; c += ACD_NT) {
      sm.seq[c] = sm.seq_tmp[c];
      sm.valid[c] = sm.valid_tmp[c];
      sm.anc[c] = sm.anc_tmp[c];
    }
    __syncthreads();

    // harvest ended beams and merge them into the K best done beams
    for (int s = tid; s < ns; s += ACD_NT) {
      const int o = s * K;
      const bool last = t == L - 1;
      const float inv_len = 1.0f / (float)(t + 1);
      const bool stopped = sm.stopped[s] != 0;
      float srcs[2 * ACD_KMAX];
      bool is_end[ACD_KMAX], chosen[2 * ACD_KMAX];
      int n_harvest = 0;
      for (int k = 0; k < K; ++k) {
        is_end[k] = sm.new_word[o + k] == a.eos || last;
        const bool hv = is_end[k] && !stopped;
        srcs[k] = sm.done_score[o + k];
        srcs[K + k] = hv ? sm.new_lp[o + k] * inv_len : ACD_NEG;
        n_harvest += srcs[K + k] > ACD_NEG / 2 ? 1 : 0;
      }
      for (int q = 0; q < 2 * K; ++q) chosen[q] = false;
      int slot_src[ACD_KMAX];
      float slot_score[ACD_KMAX];
      for (int slot = 0; slot < K; ++slot) {
        float best = ACD_NEG;
        int best_src = 0;
        for (int q = 0; q < 2 * K; ++q) {
          const float c = chosen[q] ? ACD_NEG : srcs[q];
          if (c > best) {
            best = c;
            best_src = q;
          }
        }
        slot_src[slot] = best_src;
        slot_score[slot] = best;
        chosen[best_src] = true;
      }
      for (int slot = 0; slot < K; ++slot) {
        const int q = slot_src[slot];
        const int* from = q < K ? sm.done_seq + (o + q) * L
                                : sm.seq + (o + q - K) * L;
        for (int j = 0; j < L; ++j) sm.seq_tmp[(o + slot) * L + j] = from[j];
      }
      for (int i = 0; i < K * L; ++i) sm.done_seq[o * L + i] = sm.seq_tmp[o * L + i];
      for (int slot = 0; slot < K; ++slot) sm.done_score[o + slot] = slot_score[slot];
      sm.done_count[s] += n_harvest;
      if (sm.done_count[s] >= K) sm.stopped[s] = 1;
      for (int k = 0; k < K; ++k) {
        sm.word[o + k] = sm.new_word[o + k];
        sm.topk_lp[o + k] =
            is_end[k] ? sm.new_lp[o + k] - 1000.0f : sm.new_lp[o + k];
      }
    }
    stamp(a, t, 10 * a.nl + 4);
    int alive = 0;
    for (int s = tid; s < ns; s += ACD_NT) alive |= !sm.stopped[s];
    if (__syncthreads_or(alive) == 0) break;
  }

  if (tc.rank == 0) {
    for (int i = tid; i < R * L; i += ACD_NT) {
      const int b = tc.sample0 + i / (K * L);
      if (b < a.B) a.out_seq[(long)tc.sample0 * K * L + i] = sm.done_seq[i];
    }
    for (int r = tid; r < R; r += ACD_NT) {
      const int b = tc.sample0 + r / K;
      if (b < a.B) a.out_score[(long)tc.sample0 * K + r] = sm.done_score[r];
    }
  }
  // no block may leave while a peer could still write into its memory,
  // nor with its own weight copies in flight
  asm volatile("cp.async.wait_all;\n" ::);
  cl.sync();
}

// The kernel instantiation of a mode, or null for an unknown mode.
static void (*beam_kernel(int mode))(DecodeArgs) {
  switch (mode) {
    case 0: return fused_beam_kernel<float, false>;
    case ACD_CACHE_BF16: return fused_beam_kernel<bf16, false>;
    case ACD_WEIGHTS_BF16: return fused_beam_kernel<float, true>;
    case ACD_CACHE_BF16 | ACD_WEIGHTS_BF16: return fused_beam_kernel<bf16, true>;
    default: return nullptr;
  }
}

extern "C" int fused_beam_launch(const DecodeArgs* a, void* stream) {
  void (*kernel)(DecodeArgs) = beam_kernel(a->mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return launch_clusters(kernel, *a, decode_smem_bytes(*a, true),
                         (cudaStream_t)stream);
}

extern "C" long fused_beam_smem(const DecodeArgs* a) {
  return decode_smem_bytes(*a, true);
}

extern "C" int fused_beam_max_clusters(int C, long smem, int mode) {
  void (*kernel)(DecodeArgs) = beam_kernel(mode);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  return max_active_clusters(kernel, C, smem);
}
