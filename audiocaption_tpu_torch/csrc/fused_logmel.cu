// Fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces the TPU kernel audiocaption_tpu/ops/pallas_logmel.py
// (_logmel_kernel :44-77, launched by pallas_logmel :80-147).
//
// out[b, f, m] = 10 * log10(max(sum_k |X_f[k]|^2 * fb[k, m], 1e-10)), where
// X_f[k] = sum_n wav_p[b, f * hop + n] * basis[n, k | nf + k] is the windowed
// real DFT of frame f of the reflect-padded wave (cos | -sin basis columns).
// The wrapper pads the wave (reflect n_fft/2 each side, then zeros up to
// whole tiles), so frame f starts at f * hop and the kernel never bounds-
// checks the wave; it writes only frames < n_frames.  top_db is applied by
// the wrapper, outside the kernel, as in the TPU version.
//
// One block per (tile of TILE_F frames, sample).  The block stages its wave
// window ((TILE_F - 1) * hop + n_fft floats, 44 KB at 32 kHz) in shared
// memory once.  Warp w owns frames [w * FR, w * FR + FR) of the tile; lane l
// owns bins k0 + j * 32 + l.  Each thread keeps FR x NB (re, im) sums in
// registers; the wave is read as float4 from shared memory (one address per
// warp: a broadcast) and the basis from global memory, where its 4.2 MB
// stays in L2 and the four warps of a block read the same rows (L1 hits).
// Power goes to shared memory ([TILE_F, nf], 66 KB at 32 kHz); then each
// thread sums the mel projection of a few (frame, mel) outputs over all
// bins and writes the dB value.
//
// Work: like the TPU version, this kernel computes the DFT as a dense
// product, 2 * n_fft * 2 * nf operations per frame (2.1 MFLOP at 32 kHz,
// ~2.1 GFLOP per 10 s clip), about 80x the ~26 kFLOP of a real FFT of the
// frame.  The function itself is bound by its bytes (the wave in, the
// log-mel out): ~0.03 ms for 64 clips of 10 s on an H100, where this design
// needs ~2 ms of float32 arithmetic at best.  It runs on the CUDA cores with
// register blocking (FR x 4 bins x 2 per thread, one float4 wave load per
// four basis rows); the TPU version's chunk-roll framing and 128-lane
// padding are Mosaic constraints and are not carried over.  The faster
// design is an FFT of each frame in shared memory over the bins with mel
// weight.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_F = 32;           // frames per block
constexpr int FR = 8;                // frames per warp (and per thread)
constexpr int NT = TILE_F / FR * 32; // 128 threads: 4 warps
constexpr int BB = 4;                // bins per lane in a wide chunk

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// (re, im) sums of the FR frames starting at tile row f0 for bins
// k0 + j * 32 + lane (j < NB), then their power into power_s.
template <int NB>
__device__ __forceinline__ void dft_chunk(const float* wave_s,
                                          const float* __restrict__ basis,
                                          float* power_s, int n_fft, int hop,
                                          int nf, int k0, int f0, int lane) {
  float re[FR][NB], im[FR][NB];
  int kk[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    kk[j] = min(k0 + j * 32 + lane, nf - 1);  // clamped lanes are discarded
#pragma unroll
    for (int i = 0; i < FR; ++i) re[i][j] = im[i][j] = 0.f;
  }
  const int ldb = 2 * nf;
  const float* xw = wave_s + f0 * hop;
  for (int n = 0; n < n_fft; n += 4) {
    float4 x[FR];
#pragma unroll
    for (int i = 0; i < FR; ++i)
      x[i] = *reinterpret_cast<const float4*>(xw + i * hop + n);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* row = basis + (long)(n + u) * ldb;
      float c[NB], s[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        c[j] = __ldg(row + kk[j]);
        s[j] = __ldg(row + nf + kk[j]);
      }
#pragma unroll
      for (int i = 0; i < FR; ++i) {
        const float xv = comp(x[i], u);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          re[i][j] = fmaf(xv, c[j], re[i][j]);
          im[i][j] = fmaf(xv, s[j], im[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int k = k0 + j * 32 + lane;
    if (k < nf) {
#pragma unroll
      for (int i = 0; i < FR; ++i)
        power_s[(f0 + i) * nf + k] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    }
  }
}

__global__ void __launch_bounds__(NT)
fused_logmel_kernel(const float* __restrict__ wav, int ld, int n_frames,
                    int n_fft, int hop, const float* __restrict__ basis, int nf,
                    const float* __restrict__ fb, int n_mels,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int window = (TILE_F - 1) * hop + n_fft;
  float* wave_s = smem;
  float* power_s = smem + ((window + 3) & ~3);

  const int b = blockIdx.y;
  const int frame0 = blockIdx.x * TILE_F;
  const float* src = wav + (long)b * ld + (long)frame0 * hop;
  for (int i = threadIdx.x; i < window; i += NT) wave_s[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, f0 = (threadIdx.x >> 5) * FR;
  const int wide = nf / (32 * BB) * (32 * BB);
  for (int k0 = 0; k0 < wide; k0 += 32 * BB)
    dft_chunk<BB>(wave_s, basis, power_s, n_fft, hop, nf, k0, f0, lane);
  for (int k0 = wide; k0 < nf; k0 += 32)
    dft_chunk<1>(wave_s, basis, power_s, n_fft, hop, nf, k0, f0, lane);
  __syncthreads();

  for (int idx = threadIdx.x; idx < TILE_F * n_mels; idx += NT) {
    const int f = idx / n_mels, m = idx - f * n_mels;
    if (frame0 + f >= n_frames) break;  // idx only grows: later f are out too
    const float* p = power_s + f * nf;
    float acc = 0.f;
    for (int k = 0; k < nf; ++k) acc = fmaf(p[k], __ldg(fb + k * n_mels + m), acc);
    out[((long)b * n_frames + frame0 + f) * n_mels + m] =
        10.f * log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// Shared memory the kernel needs, in bytes (0 if hop or n_fft is not a
// multiple of 4, which the float4 wave loads need).
extern "C" long fused_logmel_smem_bytes(int n_fft, int hop, int nf) {
  if (n_fft % 4 || hop % 4) return 0;
  const long window = (TILE_F - 1) * (long)hop + n_fft;
  return (((window + 3) & ~3L) + (long)TILE_F * nf) * sizeof(float);
}

extern "C" int fused_logmel_tile_frames() { return TILE_F; }

// wav [B, ld] padded as described above; basis [n_fft, 2 * nf]; fb
// [nf, n_mels]; out [B, n_frames, n_mels].  Returns cudaGetLastError().
extern "C" int fused_logmel_launch(const float* wav, int ld, int B,
                                   int n_frames, int n_fft, int hop,
                                   const float* basis, int nf, const float* fb,
                                   int n_mels, float* out, void* stream) {
  const long smem = fused_logmel_smem_bytes(n_fft, hop, nf);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n_frames + TILE_F - 1) / TILE_F, B);
  fused_logmel_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      wav, ld, n_frames, n_fft, hop, basis, nf, fb, n_mels, out);
  return (int)cudaGetLastError();
}
