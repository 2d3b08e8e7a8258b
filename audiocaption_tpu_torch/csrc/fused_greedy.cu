// Whole-loop greedy caption decode for Hopper (sm_90a).
//
// Replaces the TPU kernel audiocaption_tpu/decoding/fused_greedy.py
// (_make_kernel :209-310, launched by _fused_decode_call :313-359).
//
// One thread block decodes one row (sample) for all max_length steps:
// embedding * sqrt(E) + PE, then per layer self attention over the row's
// KV cache (positions <= t, pad tokens masked), cross attention over the
// precomputed memory K/V (memory mask), ReLU FFN and three post-LNs
// (eps 1e-5), then tied vocabulary logits and arg-max (ties -> lower id).
// Finished rows emit <eos>; a row stops early once it has emitted <eos>,
// since every later output is <eos> by definition.
//
// What bounds it: every step of every row reads all decoder weights
// (~12.5 MB in float32 at E=256, FFN 1024, V=4981, 2 layers: 3.7 MB per
// layer + 5.1 MB vocabulary), its memory K/V (2 * S * E floats per layer)
// and its cache prefix.  The weights fit the 50 MB L2, so after the first
// touch the blocks stream them from L2, not HBM: the unique HBM bytes are
// the weights once plus the memory K/V, about 13 MB at B=64, S=31
// (~4 us at 3.35 TB/s); the L2 traffic is B * L * 12.5 MB.  With one block
// per row the kernel is latency- and L2-bound; rows-per-block batching
// that reuses each weight load across rows (and wgmma) is the way down.
#include "decoder_common.cuh"

__global__ void __launch_bounds__(ACD_NT)
fused_greedy_kernel(const float* __restrict__ emb, const float* __restrict__ cls,
                    const float* __restrict__ pe,
                    const float* __restrict__ layers, const float* memkv,
                    const unsigned char* mem_valid, float* self_kv, int* out,
                    int B, int S, int L, int E, int H, int F, int V,
                    int nlayers, int bos, int eos, int pad, float sqrt_e) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem sm;
  const long used = carve_smem(smem_raw, &sm, 1, E, F, H, L, S);
  float* red_v = reinterpret_cast<float*>(smem_raw + used);
  int* red_i = reinterpret_cast<int*>(red_v + 32);
  int* word = red_i + 32;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const LayerOffsets off = layer_offsets(E, F);
  const long LE = (long)L * E, SE = (long)S * E;
  // self caches [nlayers][2][B][L][E]; memory K/V [nlayers][2][B][S][E]
  float* self_k = self_kv + (long)b * LE;
  float* self_v = self_kv + ((long)B + b) * LE;
  const float* mem_k = memkv + (long)b * SE;
  const float* mem_v = memkv + ((long)B + b) * SE;

  if (threadIdx.x == 0) word[0] = bos;
  __syncthreads();
  int t = 0;
  for (; t < L; ++t) {
    if (threadIdx.x == 0) sm.self_valid[t] = word[0] != pad;
    embed_rows(emb, pe, word, sm.x, 1, E, t, sqrt_e);
    decoder_layers(layers, off, sm, self_k, self_v, 2L * B * LE, 0, mem_k,
                   mem_v, 2L * B * SE, mem_valid + (long)b * S, nlayers, t, L,
                   S, 1, E, H, F);
    // tied logits and arg-max: one warp per vocabulary row, ascending ids
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int v = warp; v < V; v += nw) {
      const float* wr = cls + (long)v * E;
      float s = 0.f;
      for (int i = lane * 4; i < E; i += 128) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + i));
        const float4 xv = *reinterpret_cast<const float4*>(sm.x + i);
        s += wv.x * xv.x + wv.y * xv.y + wv.z * xv.z + wv.w * xv.w;
      }
      s = warp_sum(s);
      if (s > best) {
        best = s;
        best_i = v;
      }
    }
    block_argmax(best, best_i, red_v, red_i);
    const int new_word = best_i < V ? best_i : 0;
    if (threadIdx.x == 0) {
      out[(long)b * L + t] = new_word;
      word[0] = new_word;
    }
    __syncthreads();
    if (new_word == eos) break;
  }
  for (int u = t + 1 + threadIdx.x; u < L; u += blockDim.x)
    out[(long)b * L + u] = eos;
}

extern "C" int fused_greedy_launch(const float* emb, const float* cls,
                                   const float* pe, const float* layers,
                                   const float* memkv,
                                   const unsigned char* mem_valid,
                                   float* self_kv, int* out, int B, int S,
                                   int L, int E, int H, int F, int V,
                                   int nlayers, int bos, int eos, int pad,
                                   float sqrt_e, void* stream) {
  const long smem = carve_smem(nullptr, nullptr, 1, E, F, H, L, S) +
                    (32 + 32 + 4) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_greedy_kernel<<<B, ACD_NT, smem, (cudaStream_t)stream>>>(
      emb, cls, pe, layers, memkv, mem_valid, self_kv, out, B, S, L, E, H, F,
      V, nlayers, bos, eos, pad, sqrt_e);
  return (int)cudaGetLastError();
}
