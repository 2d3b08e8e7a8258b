// Whole-loop greedy caption decode for Hopper (sm_90a).
//
// Replaces the TPU kernel audiocaption_tpu/decoding/fused_greedy.py
// (_make_kernel :209-310, launched by _fused_decode_call :313-359).
//
// A cluster of C blocks decodes a tile of R samples for all max_length
// steps (decoder_common.cuh): embedding * sqrt(E) + PE, then per layer self
// attention over the row's KV cache (positions <= t, pad tokens masked),
// cross attention over the precomputed memory K/V (memory mask), ReLU FFN
// and three post-LNs (eps 1e-5), then tied vocabulary logits and arg-max.
// The pick is split with the vocabulary: each block takes the arg-max of
// its slice (ties -> lower id), pushes (value, id) per row to every block,
// and after one cluster sync every block merges the C partials in slice
// order, so every block feeds the same token.  Finished rows emit <eos>;
// the tile stops once all its rows have emitted <eos>, since every later
// output is <eos> by definition.  Rows past B (a tile that does not fill)
// are masked: finished from the start, never written.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; B=64, S=31,
// L=20, flagship width): the work is ~8.0 GFLOP of products and 12.4 MB of
// float32 weights a step, a 0.12 ms bound at the float32 peak.  The first
// design gave one block one sample and streamed all weights from L2 every
// step for one row: 8.1 ms.  Here a cluster of C blocks shares each
// weight matrix by output columns and applies each weight tile to its R
// rows (decoder_common.cuh), 3.1 ms: a step is 17 serial phases of ~1 to
// ~29 us.  The cluster syncs themselves cost ~0.5 us (1 us with a 1 KB
// exchange); the products take ~72% of a step and attention ~24%.  The
// products run on the FP64 tensor cores, for float32 parity, and are
// bound by the FP64 pipe (the float32 -> float64 conversions of each tile
// and the m8n8k4 products), not by L2: neither a deeper weight ring nor
// skipping its waits moved them.
//
// Modes: float32 (CT = float) and cache_bf16 (CT = bf16: the memory K/V
// and the self caches stored in bf16, as the TPU kernel's cache_bf16;
// half the bytes of the attention reads).  The TPU greedy kernel has no
// bf16-weight mode, so neither has this one.
#include "decoder_common.cuh"

template <typename CT>
__global__ void __launch_bounds__(ACD_NT, 1) fused_greedy_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  Smem sm;
  const long bytes = carve_smem(smem_raw, &sm, a.R, a.E, a.F, a.V, a.L, a.S,
                                a.C, false);
  zero_smem(smem_raw, bytes);
  WStream ws;

  TileCtx tc;
  tc.rank = (int)cl.block_rank();
  tc.C = a.C;
  tc.R = a.R;
  tc.Rp = sm.Rp;
  tc.ns = a.ns;
  tc.K = 1;
  ws_start(gemm_args<false>(a), tc.rank, ws, sm.rings);
  const int tile = blockIdx.x / a.C;
  tc.row0 = (long)tile * a.R;
  tc.sample0 = tile * a.ns;
  tc.rows_total = (long)a.tiles * a.R;
  const int R = a.R, L = a.L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool writer = tc.rank == 0;

  for (int r = threadIdx.x; r < R; r += ACD_NT) {
    sm.word[r] = a.bos;
    sm.flag[r] = tc.sample0 + r >= a.B;  // masked rows count as finished
  }
  __syncthreads();
  cl.sync();

  int t = 0;
  for (; t < L; ++t) {
    stamp(a, t, 0);
    for (int r = threadIdx.x; r < R; r += ACD_NT) {
      sm.valid[r * L + t] = sm.word[r] != a.pad;
      sm.anc[r * L + t] = 0;
    }
    embed_rows<false>(a.emb, a.pe, sm.word, sm.x, sm.ldE, R, a.E, t,
                      a.sqrt_e);
    decoder_layers<CT, false>(a, cl, tc, sm, ws, t);

    // the slice's logits, a warp a row for its arg-max, partials to all
    int nv;
    const int v0 = vocab_logits<false>(a, tc, sm, ws, nv);
    stamp(a, t, 10 * a.nl + 1);
    for (int r = warp; r < R; r += ACD_NW) {
      float best = -INFINITY;
      int best_i = 0x7fffffff;
      const float* lr = sm.logits + r * sm.ldV;
      for (int v = lane; v < nv; v += 32) {
        if (lr[v] > best) {
          best = lr[v];
          best_i = v0 + v;
        }
      }
      warp_argmax(best, best_i);
      if (lane == 0) {
        const long o = ((long)tc.rank * sm.Rp + r) * 2;
        push_all(cl, sm.xa, o, best, a.C);
        push_all(cl, sm.xa, o + 1, __int_as_float(best_i), a.C);
      }
    }
    cl.sync();
    stamp(a, t, 10 * a.nl + 2);

    // merge the slices in order; the same in every block
    int alive = 0;
    for (int r = threadIdx.x; r < R; r += ACD_NT) {
      float best = -INFINITY;
      int best_i = 0x7fffffff;
      for (int c = 0; c < a.C; ++c) {
        const float* p = sm.xa + ((long)c * sm.Rp + r) * 2;
        argmax_merge(best, best_i, p[0], __float_as_int(p[1]));
      }
      const int new_word = best_i < a.V ? best_i : 0;
      const int out_word = sm.flag[r] ? a.eos : new_word;
      if (new_word == a.eos) sm.flag[r] = 1;
      sm.word[r] = out_word;
      if (writer && tc.sample0 + r < a.B)
        a.out_seq[(long)(tc.sample0 + r) * L + t] = out_word;
      alive |= !sm.flag[r];
    }
    stamp(a, t, 10 * a.nl + 3);
    if (__syncthreads_or(alive) == 0) break;
  }
  if (writer) {
    for (int i = threadIdx.x; i < R * L; i += ACD_NT) {
      const int r = i / L, u = i - r * L;
      if (u > t && tc.sample0 + r < a.B)
        a.out_seq[(long)(tc.sample0 + r) * L + u] = a.eos;
    }
  }
  // no block may leave while a peer could still write into its memory,
  // nor with its own weight copies in flight
  asm volatile("cp.async.wait_all;\n" ::);
  cl.sync();
}

// The kernel instantiation of a mode, or null for a mode it lacks.
static void (*greedy_kernel(int mode))(DecodeArgs) {
  switch (mode) {
    case 0: return fused_greedy_kernel<float>;
    case ACD_CACHE_BF16: return fused_greedy_kernel<bf16>;
    default: return nullptr;
  }
}

extern "C" int fused_greedy_launch(const DecodeArgs* a, void* stream) {
  void (*kernel)(DecodeArgs) = greedy_kernel(a->mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return launch_clusters(kernel, *a, decode_smem_bytes(*a, false),
                         (cudaStream_t)stream);
}

extern "C" long fused_greedy_smem(const DecodeArgs* a) {
  return decode_smem_bytes(*a, false);
}

extern "C" int fused_greedy_max_clusters(int C, long smem, int mode) {
  void (*kernel)(DecodeArgs) = greedy_kernel(mode);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  return max_active_clusters(kernel, C, smem);
}

// Sync probe: one cluster of C blocks runs `iters` rounds of (each block
// writes n4 float4 values into every other block's shared memory, then one
// cluster sync); out[0] gets the mean round in ns (block 0's global timer).
// What one exchange-and-sync of the decode kernels costs at least.
__global__ void __launch_bounds__(ACD_NT, 1)
cluster_sync_probe_kernel(int iters, int n4, long long* out) {
  extern __shared__ __align__(16) float4 probe_buf[];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  cl.sync();
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < n4 * (C - 1); i += ACD_NT) {
      const int qi = i / n4, e = i - qi * n4;
      const int q = qi + (qi >= rank ? 1 : 0);
      cl.map_shared_rank(probe_buf, q)[rank * n4 + e] =
          make_float4((float)it, 0.f, 0.f, 0.f);
    }
    cl.sync();
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (rank == 0 && threadIdx.x == 0) out[0] = (long long)(t1 - t0) / iters;
}

extern "C" int fused_greedy_sync_probe(int C, int iters, int n4,
                                       long long* out, void* stream) {
  const long smem = 16L * (n4 > 0 ? n4 : 1) * ACD_CMAX;
  cudaError_t err;
  if (C > 8) {
    err = cudaFuncSetAttribute(cluster_sync_probe_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(cluster_sync_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(ACD_NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_sync_probe_kernel, iters, n4, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
