// Fused log-mel spectrogram for Hopper (sm_90a): an FFT of each frame in
// shared memory and a banded mel product.
//
// Replaces the TPU kernel audiocaption_tpu/ops/pallas_logmel.py
// (_logmel_kernel :44-77, launched by pallas_logmel :80-147).
//
// out[b, f, m] = 10 * log10(max(sum_k |X_f[k]|^2 * fb[k, m], 1e-10)), where
// X_f is the real DFT of frame f of the wave, reflect-padded by n_fft / 2 on
// each side (torch's center=True), times a periodic Hann window.  top_db is
// applied by the wrapper, outside the kernel, as in the TPU version.
//
// One block per (tile of TILE_F frames, sample).  The block stages its wave
// window, (TILE_F - 1) * hop + n_fft floats, in shared memory straight from
// the unpadded [B, T] wave: it computes the reflect index itself and reads
// zeros past the padded end (a ragged last tile), so the wrapper copies
// nothing.  Then each warp owns whole frames, one at a time, in its own
// buffer of M = n_fft / 2 complex values (one pad slot after every 8, so
// that no stage's stores collide on a bank):
//   1. pack the windowed frame as z[n] = x[2n] + i x[2n+1] and run an
//      M-point complex FFT: Stockham stages of radix 8 (radix 4 when M <
//      256), then one of radix M / Ns for what is left
//      (ops/fused_logmel.py::fft_radices), each a read of the buffer into
//      registers, a __syncwarp, twiddles from a host-built table, the
//      butterflies, the write in natural order, a __syncwarp;
//   2. split the complex spectrum into the real one,
//      X[k] = (Z[k] + conj Z[M-k]) / 2 - i W^k (Z[k] - conj Z[M-k]) / 2 with
//      W = exp(-2 pi i / n_fft), only for the bins [k_min, k_max) that
//      carry mel weight, and keep their power in the buffer;
//   3. per mel, sum power times the filter's packed weights over its one
//      contiguous band [lo, lo + len), take the dB value and write the
//      frame's n_mels outputs (lane m writes mel m: coalesced).
// ops/fused_logmel.py::logmel_tables builds the tables (twiddles, the
// real-split twiddles, the window, the bands) and fft_twin repeats this
// algorithm in PyTorch for the CPU tests.
//
// Bound: the function needs a real FFT per frame (~26 kFLOP at n_fft 1024)
// and is bound by its bytes (the wave in, the log-mel out): ~0.03 ms for 64
// clips of 10 s on an H100 (chip_smoke.py::logmel_work).  This design reads
// the wave once (plus the 1.14x overlap of the tile windows) and writes the
// log-mel once; the rest is shared-memory traffic, six passes over a 4 KB
// buffer per frame at n_fft 1024.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_F = 16;          // frames per block
constexpr int NWARP = 8;            // warps per block; each owns whole frames
constexpr int NT = NWARP * 32;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// -i * a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// Buffer slot of element n: one pad slot after every 8.
__device__ __forceinline__ int slot(int n) { return n + (n >> 3); }

// 4-point DFT of x, outputs at y[0], y[step], y[2 step], y[3 step].
__device__ __forceinline__ void dft4(const float2 (&x)[4], float2* y, int step) {
  const float2 a0 = cadd(x[0], x[2]), a1 = csub(x[0], x[2]);
  const float2 a2 = cadd(x[1], x[3]), a3 = mul_mi(csub(x[1], x[3]));
  y[0] = cadd(a0, a2);
  y[step] = cadd(a1, a3);
  y[2 * step] = csub(a0, a2);
  y[3 * step] = csub(a1, a3);
}

// One Stockham stage of radix R on the warp's M-point buffer: butterfly j
// reads element j + r * M / R, multiplies input r by W_M^(r * (j mod Ns) *
// M / (Ns * R)) and writes output r to element (j - j mod Ns) * R +
// j mod Ns + r * Ns.  The first stage (Ns = 1, no twiddles) reads the
// windowed frame from the wave window instead of the buffer.  Radix 8 is
// a split into sums and twiddled differences of inputs r and r + 4, then a
// 4-point DFT of each: outputs 2m and 2m + 1.
template <int M, int R, bool FIRST>
__device__ __forceinline__ void stage(float2* buf, int Ns,
                                      const float2* __restrict__ tw,
                                      const float* frame,
                                      const float2* __restrict__ win2,
                                      int lane) {
  constexpr int J = M / R / 32;     // butterflies per lane
  float2 v[J][R];
#pragma unroll
  for (int q = 0; q < J; ++q) {
    const int j = lane + 32 * q;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * (M / R);
      if constexpr (FIRST) {
        const float2 w = __ldg(win2 + n);
        v[q][r] = make_float2(frame[2 * n] * w.x, frame[2 * n + 1] * w.y);
      } else {
        v[q][r] = buf[slot(n)];
      }
    }
  }
  __syncwarp();
  const int stride = M / (Ns * R);  // twiddle index step
#pragma unroll
  for (int q = 0; q < J; ++q) {
    const int j = lane + 32 * q;
    const int jm = j & (Ns - 1);
    if constexpr (!FIRST) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[q][r] = cmul(v[q][r], __ldg(tw + jm * r * stride));
    }
    float2 y[R];
    if constexpr (R == 8) {
      constexpr float h = 0.70710678118654752f;   // 1 / sqrt 2
      float2 a[4], c[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = cadd(v[q][r], v[q][r + 4]);
        c[r] = csub(v[q][r], v[q][r + 4]);
      }
      // c[r] *= W_8^r
      c[1] = make_float2(h * (c[1].x + c[1].y), h * (c[1].y - c[1].x));
      c[2] = mul_mi(c[2]);
      c[3] = make_float2(h * (c[3].y - c[3].x), -h * (c[3].x + c[3].y));
      dft4(a, y, 2);
      dft4(c, y + 1, 2);
    } else if constexpr (R == 4) {
      dft4(v[q], y, 1);
    } else {
      y[0] = cadd(v[q][0], v[q][1]);
      y[1] = csub(v[q][0], v[q][1]);
    }
    const int dst = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[slot(dst + r * Ns)] = y[r];
  }
  __syncwarp();
}

struct Tables {
  const float2* tw;      // [M]      W_M^t = exp(-2 pi i t / M)
  const float2* split;   // [M + 1]  W^k = exp(-2 pi i k / n_fft)
  const float2* win2;    // [M]      (window[2n], window[2n + 1])
  const int* bands;      // [3, n_mels]: lo, len, offset into band_w
  const float* band_w;   // packed filter weights
  int k_min, k_max, n_mels;
};

// Three blocks an SM (85 registers a thread) up to n_fft 1024: left free,
// the compiler takes 128 for the radix-8 stages and fits two.
template <int LOG2M>
__global__ void __launch_bounds__(NT, LOG2M <= 9 ? 3 : 1)
fused_logmel_kernel(const float* __restrict__ wav, int T, int n_frames,
                    int hop, Tables t, float* __restrict__ out) {
  constexpr int M = 1 << LOG2M, N = 2 * M, pad = M, SLOTS = M + M / 8;
  constexpr int R0 = M >= 256 ? 8 : 4;     // radix of all stages but the last
  extern __shared__ __align__(16) float smem[];
  const int window = (TILE_F - 1) * hop + N;
  float* wave_s = smem;
  float2* bufs = reinterpret_cast<float2*>(smem + ((window + 3) & ~3));

  const int b = blockIdx.y;
  const int frame0 = blockIdx.x * TILE_F;
  const float* src = wav + (long)b * T;
  const int p0 = frame0 * hop - pad, p_end = T + pad;  // padded span, shifted
  for (int i = threadIdx.x; i < window; i += NT) {
    int s = p0 + i;  // index into the unpadded wave before the reflection
    float v = 0.f;
    if (s < p_end) {
      s = s < 0 ? -s : s;
      s = s >= T ? 2 * (T - 1) - s : s;
      v = __ldg(src + s);
    }
    wave_s[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2* buf = bufs + warp * SLOTS;
  float* pbuf = reinterpret_cast<float*>(buf);
  constexpr int KP = M / 32 + 1;    // bins per lane, at most
  for (int fl = warp; fl < TILE_F; fl += NWARP) {
    const int f = frame0 + fl;
    if (f >= n_frames) break;
    // 1. FFT of the packed frame
    stage<M, R0, true>(buf, 1, t.tw, wave_s + fl * hop, t.win2, lane);
    int Ns = R0;
    for (; Ns * R0 <= M; Ns *= R0)
      stage<M, R0, false>(buf, Ns, t.tw, nullptr, nullptr, lane);
    if (M / Ns == 4) stage<M, 4, false>(buf, Ns, t.tw, nullptr, nullptr, lane);
    if (M / Ns == 2) stage<M, 2, false>(buf, Ns, t.tw, nullptr, nullptr, lane);

    // 2. real split and power of the bins with mel weight
    float pw[KP];
#pragma unroll
    for (int q = 0; q < KP; ++q) {
      const int k = t.k_min + lane + 32 * q;
      if (k < t.k_max) {
        const float2 a = buf[slot(k & (M - 1))], c = buf[slot((M - k) & (M - 1))];
        const float2 xe = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
        const float2 xo = mul_mi(make_float2(0.5f * (a.x - c.x),
                                             0.5f * (a.y + c.y)));
        const float2 X = cadd(xe, cmul(__ldg(t.split + k), xo));
        pw[q] = X.x * X.x + X.y * X.y;
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < KP; ++q) {
      const int k = t.k_min + lane + 32 * q;
      if (k < t.k_max) pbuf[k - t.k_min] = pw[q];
    }
    __syncwarp();

    // 3. banded mel product, dB, one coalesced row of n_mels
    float* orow = out + ((long)b * n_frames + f) * t.n_mels;
    for (int m = lane; m < t.n_mels; m += 32) {
      const int lo = __ldg(t.bands + m) - t.k_min;
      const int len = __ldg(t.bands + t.n_mels + m);
      const float* w = t.band_w + __ldg(t.bands + 2 * t.n_mels + m);
      float acc = 0.f;
      for (int i = 0; i < len; ++i) acc = fmaf(pbuf[lo + i], __ldg(w + i), acc);
      orow[m] = 10.f * log10f(fmaxf(acc, 1e-10f));
    }
    __syncwarp();  // the buffer is the next frame's
  }
}

template <int LOG2M>
int launch(const float* wav, int B, int T, int n_frames, int hop,
           const Tables& t, float* out, cudaStream_t stream, long smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_logmel_kernel<LOG2M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n_frames + TILE_F - 1) / TILE_F, B);
  fused_logmel_kernel<LOG2M><<<grid, NT, smem, stream>>>(wav, T, n_frames,
                                                         hop, t, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs, in bytes: the wave window and one
// M-point complex buffer per warp (with its pad slots).
extern "C" long fused_logmel_smem_bytes(int n_fft, int hop) {
  const long window = (TILE_F - 1) * (long)hop + n_fft;
  return (((window + 3) & ~3L) + (long)NWARP * (n_fft + n_fft / 8)) *
         sizeof(float);
}

// wav [B, T] (unpadded, T > n_fft / 2); tables as in Tables above, built by
// ops/fused_logmel.py::logmel_tables; out [B, n_frames, n_mels].  n_fft is
// a power of two from 256 to 2048 (cudaErrorInvalidValue otherwise).
// Returns cudaGetLastError() after the launch.
extern "C" int fused_logmel_launch(const float* wav, int B, int T,
                                   int n_frames, int n_fft, int hop,
                                   const void* tw, const void* split,
                                   const void* win2, const int* bands,
                                   const float* band_w, int k_min, int k_max,
                                   int n_mels, float* out, void* stream) {
  const Tables t{(const float2*)tw, (const float2*)split, (const float2*)win2,
                 bands, band_w, k_min, k_max, n_mels};
  const long smem = fused_logmel_smem_bytes(n_fft, hop);
  if (T <= n_fft / 2 || k_min < 0 || k_max > n_fft / 2 + 1 || k_min > k_max ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
    case 256: return launch<7>(wav, B, T, n_frames, hop, t, out, s, smem);
    case 512: return launch<8>(wav, B, T, n_frames, hop, t, out, s, smem);
    case 1024: return launch<9>(wav, B, T, n_frames, hop, t, out, s, smem);
    case 2048: return launch<10>(wav, B, T, n_frames, hop, t, out, s, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}
