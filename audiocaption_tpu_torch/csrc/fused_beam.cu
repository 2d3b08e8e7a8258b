// Whole-loop beam-K caption search for Hopper (sm_90a).
//
// Replaces the TPU kernel audiocaption_tpu/decoding/fused_beam.py
// (_make_beam_kernel :126-384, launched by _fused_beam_call :387-447).
//
// One thread block owns one sample and its K beams (K <= 4) for all
// max_length steps, so the top-K over [K*V], the parent-beam gather and
// the done-beam merge never leave the block.  Per step: the decoder
// layers of decoder_common.cuh on K rows (the memory K/V is stored once
// per sample and shared by the beams), tied logits, log-softmax, running
// beam score (only beam 0 competes at t=0), K rounds of block arg-max with
// the picked entry masked (ties -> lower flat index k*V + w, as lax.top_k),
// parent gather of the self K/V caches (ping-pong pair in global scratch),
// of the sequences and of the pad flags, harvest of ended beams with score
// / (t+1) (every beam is harvested at t=L-1), stable best-K merge of done
// beams and candidates, -1000 on ended beams.  A sample stops once K beams
// are done: later steps could not change its result.
//
// What bounds it: as the greedy kernel, every step reads all decoder
// weights (~12.5 MB float32 at the flagship width) once per block, now
// applied to K rows, plus the sample's memory K/V and the K cache
// prefixes; the parent gather copies 2 * nlayers * K * (t+1) * E floats of
// cache per step.  The weights stay in the 50 MB L2; the unique HBM bytes
// are about 13 MB at B=64, S=31 (~4 us at 3.35 TB/s), the L2 traffic is
// B * L * 12.5 MB.  One block per sample keeps the search logic in shared
// memory with no grid-wide sync; wgmma over many samples per block is the
// way to fewer L2 bytes per token.
#include "decoder_common.cuh"

#define ACD_NEG (-3.0e38f)  // the TPU kernel's stand-in for float32 min

struct BeamSmem {
  float* logits;      // [K, V]  logits, then log-probabilities
  float* red_v;       // [32]
  int* red_i;         // [32]
  float* topk_lp;     // [RMAX]  running beam scores
  float* new_lp;      // [RMAX]
  float* done_score;  // [RMAX]
  int* word;          // [RMAX]  fed tokens
  int* prev_beam;     // [RMAX]
  int* new_word;      // [RMAX]
  int* picks;         // [RMAX]  flat indices picked this step
  int* flags;         // [2]     done_count, stopped
  int* seq;           // [RMAX, L]
  int* seq_tmp;       // [RMAX, L]
  int* done_seq;      // [RMAX, L]
  unsigned char* valid_tmp;  // [RMAX, L]
};

__host__ __device__ inline long carve_beam(char* base, BeamSmem* bs, long p,
                                           int K, int V, int L) {
  auto take = [&](long n_words) {
    char* ptr = base + p;
    p += ((n_words + 3) / 4) * 16;
    return ptr;
  };
  BeamSmem s;
  s.logits = reinterpret_cast<float*>(take((long)K * V));
  s.red_v = reinterpret_cast<float*>(take(32));
  s.red_i = reinterpret_cast<int*>(take(32));
  s.topk_lp = reinterpret_cast<float*>(take(ACD_RMAX));
  s.new_lp = reinterpret_cast<float*>(take(ACD_RMAX));
  s.done_score = reinterpret_cast<float*>(take(ACD_RMAX));
  s.word = reinterpret_cast<int*>(take(ACD_RMAX));
  s.prev_beam = reinterpret_cast<int*>(take(ACD_RMAX));
  s.new_word = reinterpret_cast<int*>(take(ACD_RMAX));
  s.picks = reinterpret_cast<int*>(take(ACD_RMAX));
  s.flags = reinterpret_cast<int*>(take(4));
  s.seq = reinterpret_cast<int*>(take((long)ACD_RMAX * L));
  s.seq_tmp = reinterpret_cast<int*>(take((long)ACD_RMAX * L));
  s.done_seq = reinterpret_cast<int*>(take((long)ACD_RMAX * L));
  s.valid_tmp = reinterpret_cast<unsigned char*>(take(((long)ACD_RMAX * L + 3) / 4));
  if (bs) *bs = s;
  return p;
}

__global__ void __launch_bounds__(ACD_NT)
fused_beam_kernel(const float* __restrict__ emb, const float* __restrict__ cls,
                  const float* __restrict__ pe,
                  const float* __restrict__ layers, const float* memkv,
                  const unsigned char* mem_valid, float* self_kv,
                  int* out_seq, float* out_score, int B, int S, int L, int E,
                  int H, int F, int V, int nlayers, int K, int bos, int eos,
                  int pad, float sqrt_e) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem sm;
  BeamSmem bs;
  const long used = carve_smem(smem_raw, &sm, K, E, F, H, L, S);
  carve_beam(smem_raw, &bs, used, K, V, L);

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const LayerOffsets off = layer_offsets(E, F);
  const long LE = (long)L * E, SE = (long)S * E;
  // self caches [2 (ping-pong)][nlayers][2][B][K][L][E]
  const long layer_stride = 2L * B * K * LE;
  const long pp_stride = (long)nlayers * layer_stride;
  const float* mem_k = memkv + (long)b * SE;
  const float* mem_v = memkv + ((long)B + b) * SE;
  const unsigned char* mvalid = mem_valid + (long)b * S;

  for (int i = tid; i < ACD_RMAX * L; i += nt) {
    bs.seq[i] = eos;
    bs.done_seq[i] = eos;
  }
  if (tid < ACD_RMAX) {
    bs.word[tid] = bos;
    bs.topk_lp[tid] = 0.f;
    bs.done_score[tid] = ACD_NEG;
  }
  if (tid == 0) {
    bs.flags[0] = 0;  // done_count
    bs.flags[1] = 0;  // stopped
  }
  __syncthreads();

  int pp = 0;
  for (int t = 0; t < L; ++t) {
    float* cache = self_kv + pp * pp_stride;
    float* self_k = cache + (long)b * K * LE;
    float* self_v = cache + ((long)B + b) * K * LE;
    if (tid < K) sm.self_valid[tid * L + t] = bs.word[tid] != pad;
    embed_rows(emb, pe, bs.word, sm.x, K, E, t, sqrt_e);
    decoder_layers(layers, off, sm, self_k, self_v, layer_stride, LE, mem_k,
                   mem_v, 2L * B * SE, mvalid, nlayers, t, L, S, K, E, H, F);

    // tied logits, then log-softmax per beam row
    matvec(cls, nullptr, sm.x, E, bs.logits, V, K, V, E, false);
    for (int r = 0; r < K; ++r) {
      float* lr = bs.logits + (long)r * V;
      float m = -INFINITY;
      for (int v = tid; v < V; v += nt) m = fmaxf(m, lr[v]);
      m = block_reduce(m, bs.red_v, true);
      float s = 0.f;
      for (int v = tid; v < V; v += nt) s += expf(lr[v] - m);
      s = block_reduce(s, bs.red_v, false);
      const float lse = logf(s);
      for (int v = tid; v < V; v += nt) lr[v] = (lr[v] - m) - lse;
      __syncthreads();
    }

    // top-K over the K*V totals; picked entries fall back to ACD_NEG
    for (int sel = 0; sel < K; ++sel) {
      float best = -INFINITY;
      int best_i = 0x7fffffff;
      for (int f = tid; f < K * V; f += nt) {
        const int k = f / V;
        float val = (t == 0 && k > 0) ? ACD_NEG : bs.logits[f] + bs.topk_lp[k];
        for (int q = 0; q < sel; ++q)
          if (bs.picks[q] == f) val = ACD_NEG;
        if (val > best) {
          best = val;
          best_i = f;
        }
      }
      block_argmax(best, best_i, bs.red_v, bs.red_i);
      if (best_i >= K * V) best_i = 0;  // all-NaN row: keep indices valid
      if (tid == 0) {
        bs.picks[sel] = best_i;
        bs.new_lp[sel] = best;
        bs.prev_beam[sel] = best_i / V;
        bs.new_word[sel] = best_i % V;
      }
      __syncthreads();
    }

    // parent-beam gather of caches (rows <= t), sequences and pad flags
    const int pong = 1 - pp;
    float* dst_cache = self_kv + pong * pp_stride;
    const long rows = (long)(t + 1) * E;
    const long n_copy = (long)nlayers * 2 * K * rows;
    for (long c = tid; c < n_copy; c += nt) {
      const long within = c % rows;
      const int kt = (int)((c / rows) % K);
      const long ikv = c / (rows * K);  // layer * 2 + (0: K, 1: V)
      const long base = (ikv / 2) * layer_stride +
                        ((ikv % 2) * B + b) * K * LE;
      dst_cache[base + kt * LE + within] =
          cache[base + bs.prev_beam[kt] * LE + within];
    }
    for (int c = tid; c < K * L; c += nt) {
      const int kt = c / L, j = c % L, src = bs.prev_beam[kt];
      bs.seq_tmp[c] = j < t ? bs.seq[src * L + j]
                            : (j == t ? bs.new_word[kt] : eos);
      bs.valid_tmp[c] = j <= t ? sm.self_valid[src * L + j] : 1;
    }
    __syncthreads();
    for (int c = tid; c < K * L; c += nt) {
      bs.seq[c] = bs.seq_tmp[c];
      sm.self_valid[c] = bs.valid_tmp[c];
    }
    pp = pong;
    __syncthreads();

    // harvest ended beams and merge them into the K best done beams
    if (tid == 0) {
      const bool last = t == L - 1;
      const float inv_len = 1.0f / (float)(t + 1);
      const bool stopped = bs.flags[1] != 0;
      float srcs[2 * ACD_RMAX];
      bool is_end[ACD_RMAX], chosen[2 * ACD_RMAX];
      int n_harvest = 0;
      for (int k = 0; k < K; ++k) {
        is_end[k] = bs.new_word[k] == eos || last;
        const bool hv = is_end[k] && !stopped;
        srcs[k] = bs.done_score[k];
        srcs[K + k] = hv ? bs.new_lp[k] * inv_len : ACD_NEG;
        n_harvest += srcs[K + k] > ACD_NEG / 2 ? 1 : 0;
      }
      for (int s = 0; s < 2 * K; ++s) chosen[s] = false;
      int slot_src[ACD_RMAX];
      float slot_score[ACD_RMAX];
      for (int slot = 0; slot < K; ++slot) {
        float best = ACD_NEG;
        int best_src = 0;
        for (int s = 0; s < 2 * K; ++s) {
          const float c = chosen[s] ? ACD_NEG : srcs[s];
          if (c > best) {
            best = c;
            best_src = s;
          }
        }
        slot_src[slot] = best_src;
        slot_score[slot] = best;
        chosen[best_src] = true;
      }
      for (int slot = 0; slot < K; ++slot) {
        const int s = slot_src[slot];
        const int* from = s < K ? bs.done_seq + s * L : bs.seq + (s - K) * L;
        for (int j = 0; j < L; ++j) bs.seq_tmp[slot * L + j] = from[j];
      }
      for (int i = 0; i < K * L; ++i) bs.done_seq[i] = bs.seq_tmp[i];
      for (int slot = 0; slot < K; ++slot) bs.done_score[slot] = slot_score[slot];
      bs.flags[0] += n_harvest;
      if (bs.flags[0] >= K) bs.flags[1] = 1;
      for (int k = 0; k < K; ++k) {
        bs.word[k] = bs.new_word[k];
        bs.topk_lp[k] = is_end[k] ? bs.new_lp[k] - 1000.0f : bs.new_lp[k];
      }
    }
    __syncthreads();
    if (bs.flags[1]) break;
  }

  for (int i = tid; i < K * L; i += nt)
    out_seq[(long)b * K * L + i] = bs.done_seq[i];
  if (tid < K) out_score[(long)b * K + tid] = bs.done_score[tid];
}

extern "C" int fused_beam_launch(const float* emb, const float* cls,
                                 const float* pe, const float* layers,
                                 const float* memkv,
                                 const unsigned char* mem_valid,
                                 float* self_kv, int* out_seq,
                                 float* out_score, int B, int S, int L, int E,
                                 int H, int F, int V, int nlayers, int K,
                                 int bos, int eos, int pad, float sqrt_e,
                                 void* stream) {
  if (K < 1 || K > ACD_RMAX) return (int)cudaErrorInvalidValue;
  const long smem = carve_beam(nullptr, nullptr,
                               carve_smem(nullptr, nullptr, K, E, F, H, L, S),
                               K, V, L);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_beam_kernel<<<B, ACD_NT, smem, (cudaStream_t)stream>>>(
      emb, cls, pe, layers, memkv, mem_valid, self_kv, out_seq, out_score, B,
      S, L, E, H, F, V, nlayers, K, bos, eos, pad, sqrt_e);
  return (int)cudaGetLastError();
}
