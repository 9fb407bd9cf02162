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
// carry hash 0, strand 0, keep 0.  Codes are 2-bit base codes (0-3), the
// contract of sketch_plain and unpack_codes.
//
// What bounds it on an H100: memory bytes.  Per position the function
// reads one code byte and writes a 4-byte hash plus two flag bytes (7
// bytes); at the fewest it needs some 34 integer instructions for the same
// position (rolling k-mer updates, canonical pick and flags, the mix at 14
// with its multiply-adds as one IMAD each, the two window passes), about 5
// per byte against the card's ~10 (33.5 T instructions/s issued over
// 3.35 TB/s).  So the design keeps the instructions a position near that
// count and moves every byte in 16-byte accesses.
//
// Design: one block of 128 threads per segment row; each thread owns
// strips of 16 consecutive positions.
//   * It reads the strip's codes and the k - 1 that follow as two 16-byte
//     loads, and rolls the k-mers along the strip from its right end, so
//     every code sits at a fixed register: fk = (fk >> 2) | c << 2(k-1),
//     rk = ((rk << 2) | (c ^ 3)) & mask, five instructions a position.
//   * It writes the hashes as four 16-byte stores and the strand and keep
//     flags as one 16-byte store each.
//   * The window minimum and the covering maximum run over the strip in
//     registers; the (w - 1)-position halo comes from the neighbouring
//     strip through shared memory, where each strip leaves its window
//     hashes and then its window minima (16-byte shared loads and stores,
//     two barriers a row).  Windows wider than 16 read shared memory
//     position by position.
//   * A row whose width L is not a multiple of 16, or whose base is not
//     16-byte aligned, loads and stores byte by byte, as does the last
//     strip of any row where it passes L.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (see raven_tpu_torch/csrc/__init__.py); the launcher returns
// the CUDA error code and the Python wrapper raises on any non-zero value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kInf = 0xFFFFFFFFu;
constexpr int kThreads = 128;
constexpr int kS = 16;     // positions a strip
constexpr int kMaxW = 16;  // windows up to this width run in registers

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

// 16 bytes of a row from position p: one 16-byte load where the row is
// aligned and holds them, else byte by byte (0 past L)
__device__ __forceinline__ uint4 load16(const uint8_t* row, int p, int L, bool vec) {
  if (vec && p + kS <= L) return *reinterpret_cast<const uint4*>(row + p);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    if (p + j < L) w[j / 4] |= static_cast<uint32_t>(row[p + j]) << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 flag bytes (one per bit-0 byte of v) at position p
__device__ __forceinline__ void store_flags(uint8_t* row, int p, int L, bool vec,
                                            const uint32_t (&v)[kS]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = v[4 * q] | (v[4 * q + 1] << 8) | (v[4 * q + 2] << 16) | (v[4 * q + 3] << 24);
  }
  if (vec && p + kS <= L) {
    *reinterpret_cast<uint4*>(row + p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    if (p + j < L) row[p + j] = static_cast<uint8_t>(v[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
sketch_rows_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ lengths,
                   int32_t* __restrict__ hash_out,
                   uint8_t* __restrict__ strand_out,
                   uint8_t* __restrict__ keep_out,
                   int L, int k, int w) {
  extern __shared__ uint4 smem4[];
  const int nst = (L + kS - 1) / kS;  // strips a row
  const int lp = nst * kS;
  // [lp + 16] window hashes, kInf past n; [16 + lp] window minima after
  // 16 leading zeros
  uint32_t* s_h = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* s_m = s_h + lp + kS;

  const int64_t r = blockIdx.x;
  const uint8_t* src = codes + r * L;
  int32_t* h_row = hash_out + r * L;
  uint8_t* s_row = strand_out + r * L;
  uint8_t* k_row = keep_out + r * L;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(h_row) |
                     reinterpret_cast<uintptr_t>(s_row) |
                     reinterpret_cast<uintptr_t>(k_row)) & 15u) == 0;
  const int n = L - k + 1;
  const int last = lengths[r] - k;  // last valid k-mer start (may be < 0)
  const uint32_t mask = (k >= 16) ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
  const int shf = 2 * (k - 1);

  if (threadIdx.x < kS) {
    s_h[lp + threadIdx.x] = kInf;
    s_m[threadIdx.x] = 0;
  }

  // pass 1: k-mers, hashes, strands; window hashes to shared memory
  for (int st = threadIdx.x; st < nst; st += blockDim.x) {
    const int p0 = st * kS;
    const uint4 a = load16(src, p0, L, vec);
    const uint4 b = load16(src, p0 + kS, L, vec);
    const uint32_t cw[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t c[2 * kS];
#pragma unroll
    for (int j = 0; j < 2 * kS; ++j) c[j] = (cw[j / 4] >> (8 * (j % 4))) & 3u;
    // the k-mer at the strip's last position, then rolled leftwards
    uint32_t fk = 0, rk = 0;
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      if (j < k) {
        fk = (fk << 2) | c[kS - 1 + j];
        rk |= (c[kS - 1 + j] ^ 3u) << (2 * j);
      }
    }
    uint32_t hv[kS], hw[kS], sv[kS];
#pragma unroll
    for (int i = kS - 1; i >= 0; --i) {
      if (i < kS - 1) {
        fk = (fk >> 2) | (c[i] << shf);
        rk = ((rk << 2) | (c[i] ^ 3u)) & mask;
      }
      const int p = p0 + i;
      if (p < n) {
        const uint32_t h = hash_mix32(fk < rk ? fk : rk, mask);
        hv[i] = h;
        hw[i] = (fk == rk || p > last) ? kInf : h;
        sv[i] = fk <= rk ? 1u : 0u;
      } else {
        hv[i] = 0;
        hw[i] = kInf;
        sv[i] = 0;
      }
    }
    if (vec && p0 + kS <= L) {
      uint4* dst = reinterpret_cast<uint4*>(h_row + p0);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = make_uint4(hv[4 * q], hv[4 * q + 1], hv[4 * q + 2], hv[4 * q + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kS; ++i)
        if (p0 + i < L) h_row[p0 + i] = static_cast<int32_t>(hv[i]);
    }
    store_flags(s_row, p0, L, vec, sv);
    uint4* sh = reinterpret_cast<uint4*>(s_h + p0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      sh[q] = make_uint4(hw[4 * q], hw[4 * q + 1], hw[4 * q + 2], hw[4 * q + 3]);
  }
  __syncthreads();

  // pass 2: window j covers positions [j, j + w); it is valid iff its last
  // position is a valid k-mer start (then every position lies below n)
  for (int st = threadIdx.x; st < nst; st += blockDim.x) {
    const int p0 = st * kS;
    uint32_t m[kS];
    if (w <= kMaxW) {
      uint32_t e[2 * kS];
      const uint4* sh = reinterpret_cast<const uint4*>(s_h + p0);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = sh[q];
        e[4 * q] = v.x;
        e[4 * q + 1] = v.y;
        e[4 * q + 2] = v.z;
        e[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) m[i] = e[i];
#pragma unroll
      for (int t = 1; t < kMaxW; ++t) {
        if (t >= w) break;
#pragma unroll
        for (int i = 0; i < kS; ++i) m[i] = min(m[i], e[i + t]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        uint32_t v = kInf;
        for (int t = 0; t < w; ++t) {
          const int q = p0 + i + t;
          v = min(v, q < lp ? s_h[q] : kInf);
        }
        m[i] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int p = p0 + i;
      if (!(p < n && p + (w - 1) <= last)) m[i] = 0;
    }
    uint4* sm = reinterpret_cast<uint4*>(s_m + kS + p0);
#pragma unroll
    for (int q = 0; q < 4; ++q) sm[q] = make_uint4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
  }
  __syncthreads();

  // pass 3: position p is kept iff some window in [p - w + 1, p] has its
  // minimum equal to its window hash (and that is a real hash)
  for (int st = threadIdx.x; st < nst; st += blockDim.x) {
    const int p0 = st * kS;
    uint32_t cov[kS];
    if (w <= kMaxW) {
      uint32_t e[2 * kS];  // window minima of positions p0 - 16 .. p0 + 15
      const uint4* sm = reinterpret_cast<const uint4*>(s_m + p0);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = sm[q];
        e[4 * q] = v.x;
        e[4 * q + 1] = v.y;
        e[4 * q + 2] = v.z;
        e[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) cov[i] = e[kS + i];
#pragma unroll
      for (int t = 1; t < kMaxW; ++t) {
        if (t >= w) break;
#pragma unroll
        for (int i = 0; i < kS; ++i) cov[i] = max(cov[i], e[kS + i - t]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        uint32_t v = 0;
        for (int t = 0; t < w; ++t) {
          const int q = p0 + i - t;
          v = max(v, q >= 0 ? s_m[kS + q] : 0u);
        }
        cov[i] = v;
      }
    }
    const uint4* sh = reinterpret_cast<const uint4*>(s_h + p0);
    uint32_t kv[kS];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = sh[q];
      const uint32_t hq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * q + u;
        kv[i] = (p0 + i < n && hq[u] != kInf && cov[i] == hq[u]) ? 1u : 0u;
      }
    }
    store_flags(k_row, p0, L, vec, kv);
  }
}

}  // namespace

extern "C" {

size_t raven_sketch_smem_bytes(int L) {
  const size_t lp = static_cast<size_t>((L + kS - 1) / kS) * kS;
  return (2 * lp + 2 * kS) * sizeof(uint32_t);
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
