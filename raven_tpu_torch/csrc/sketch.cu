// Segment sketch kernel K1: (k,w)-minimizer hashes, strands and robust-
// winnowing keep flags for fixed-width read segment rows.
//
// Replaces the TPU kernel raven_tpu/ops/pallas_sketch.py::pallas_sketch
// (_sketch_tile_kernel, _hash_mix32) and computes what it computes, bit for
// bit: per position p < n = L - k + 1 the forward and reverse-complement
// k-mer codes fk and rk, the canonical min(fk, rk), its 32-bit invertible
// mix masked to 2k bits, the strand flag fk <= rk and the ambiguity flag
// fk == rk; then a w-window minimum over the hashes (ambiguous and
// out-of-length positions count as +inf) and a covering maximum over the
// window minima, which together give the keep flags.  Positions p >= n
// carry hash 0, strand 0, keep 0.
//
// What bounds it on an H100: memory bytes.  Per position the function
// reads one code byte and writes a 4-byte hash plus two flag bytes (7
// bytes); at the fewest it needs some 34 integer instructions for the same
// position (rolling k-mer updates, canonical pick and flags, the mix at 14
// with its multiply-adds as one IMAD each, the two window passes), about 5
// per byte against the card's ~10 (33.5 T instructions/s issued over
// 3.35 TB/s).  The design touches device memory once per byte: one block
// per segment row stages the row's codes in shared memory, keeps the window
// hashes and window minima in shared memory between the two dependent
// sliding passes, and writes the three outputs with neighbouring threads on
// neighbouring addresses.  It is not yet frugal with instructions: each
// thread rebuilds its k-mer from k codes instead of rolling it, some 4k
// more per position, which puts this first version's own instruction count
// above its byte time.  Rows are independent, so the grid is exactly S
// blocks and a ragged S needs no padding.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (see raven_tpu_torch/csrc/__init__.py); the launcher returns
// the CUDA error code and the Python wrapper raises on any non-zero value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kInf = 0xFFFFFFFFu;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t hash_mix32(uint32_t key, uint32_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = (key + (key << 3) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = (key + (key << 2) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

__global__ void __launch_bounds__(kThreads)
sketch_rows_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ lengths,
                   int32_t* __restrict__ hash_out,
                   uint8_t* __restrict__ strand_out,
                   uint8_t* __restrict__ keep_out,
                   int L, int k, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* hwin = smem;            // [L] window hash, kInf = not a candidate
  uint32_t* wmin = smem + L;        // [L] window minimum, 0 = invalid window
  uint8_t* row = reinterpret_cast<uint8_t*>(smem + 2 * L);  // [L] codes

  const int64_t r = blockIdx.x;
  const uint8_t* src = codes + r * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) row[i] = src[i];
  __syncthreads();

  const int n = L - k + 1;
  const int last = lengths[r] - k;  // last valid k-mer start (may be < 0)
  const uint32_t mask = (k >= 16) ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
  int32_t* h_row = hash_out + r * L;
  uint8_t* s_row = strand_out + r * L;

  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    if (p < n) {
      uint32_t fk = 0, rk = 0;
      for (int j = 0; j < k; ++j) {
        const uint32_t c = row[p + j];
        fk |= c << (2 * (k - 1 - j));
        rk |= (c ^ 3u) << (2 * j);
      }
      const bool ambiguous = fk == rk;
      const uint32_t h = hash_mix32(fk < rk ? fk : rk, mask);
      hwin[p] = (ambiguous || p > last) ? kInf : h;
      h_row[p] = static_cast<int32_t>(h);
      s_row[p] = fk <= rk ? 1 : 0;
    } else {
      hwin[p] = kInf;
      h_row[p] = 0;
      s_row[p] = 0;
    }
  }
  __syncthreads();

  // window j covers positions [j, j + w); it is valid iff its last
  // position is a valid k-mer start
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    uint32_t m = 0;
    if (p < n && p + (w - 1) <= last) {
      m = kInf;
      for (int t = 0; t < w; ++t) {
        const int q = p + t;
        const uint32_t v = q < L ? hwin[q] : kInf;
        m = v < m ? v : m;
      }
    }
    wmin[p] = m;
  }
  __syncthreads();

  // position p is kept iff some window in [p - w + 1, p] has its minimum
  // equal to hwin[p] (and hwin[p] is a real hash)
  uint8_t* k_row = keep_out + r * L;
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    uint8_t keep = 0;
    if (p < n) {
      const uint32_t hv = hwin[p];
      uint32_t cov = 0;
      for (int t = 0; t < w; ++t) {
        const int q = p - t;
        const uint32_t v = q >= 0 ? wmin[q] : 0u;
        cov = v > cov ? v : cov;
      }
      keep = (hv != kInf && cov == hv) ? 1 : 0;
    }
    k_row[p] = keep;
  }
}

}  // namespace

extern "C" {

size_t raven_sketch_smem_bytes(int L) {
  return static_cast<size_t>(L) * (2 * sizeof(uint32_t) + 1);
}

// Launches K1 on `stream` over S rows of width L.  Returns the CUDA error
// code of the launch (0 on success).
int raven_sketch_launch(const void* codes, const void* lengths, void* hash_out,
                        void* strand_out, void* keep_out, long long S, int L,
                        int k, int w, void* stream) {
  const size_t smem = raven_sketch_smem_bytes(L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sketch_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sketch_rows_kernel<<<static_cast<unsigned int>(S), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths),
      static_cast<int32_t*>(hash_out), static_cast<uint8_t*>(strand_out),
      static_cast<uint8_t*>(keep_out), L, k, w);
  return static_cast<int>(cudaGetLastError());
}

const char* raven_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
