// Token-packed ragged paged attention, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention_ragged
//   (grid body _ragged_impl via _ragged_kernel).
// Same contract as repro_torch/kernels/ref.py::paged_attention_ragged_ref:
// sequence s owns packed rows [q_starts[s], q_starts[s] + q_lens[s]); row t
// sits at q_pos = pos0[s] + t - q_starts[s] and attends to every kv_pos with
// kv_pos < context_lens[s], kv_pos <= q_pos and, with a window,
// q_pos - kv_pos < window, reading K/V through block_tables[s, kv_pos / page].
// A row with no visible key gives 0. Rows owned by no sequence are left
// untouched: the wrapper hands in a zeroed output.
//
// What bounds it on the H100: in decode the bytes of K/V read from device
// memory (each key is used by only the G query heads of its KV head), so
// the kernel must stream every visible K/V row once per (sequence, KV head,
// row tile) and never anything past the context. In long prefill chunks the
// fp32 dot products (CUDA cores; no TF32) dominate.
//
// Design. The TPU kernel carries its online-softmax state across a
// sequential (seq, page_block) grid; on the GPU blocks run in parallel and
// in no order, so each block owns one (sequence, KV head, tile of that
// sequence's rows) and loops over the sequence's keys itself:
//   * the block holds the G query heads of its KV head together, as the
//     Pallas kernel packs them, so a K/V row loaded once into shared memory
//     serves all 16 query vectors (rows x heads) of the tile;
//   * the key loop runs from the window's first key of the tile's first row
//     to min(context_len, last row's q_pos + 1) in tiles of 32 keys, and
//     loads only keys below context_len (garbage past the context never
//     reaches the sum, not even multiplied by 0);
//   * warp w owns query vectors 4w..4w+3: lane j scores key j against them
//     (the row-wise max and sum are warp shuffles), then 8 lanes per vector
//     accumulate P.V over D in float4 registers; online softmax in fp32.
// Blocks find their (sequence, tile) by a warp scan over q_lens, so the
// launch needs no host-side knowledge of the ragged layout. wgmma, TMA and
// split-K over long contexts are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kVecPerWarp = 4;                         // query vectors / warp
constexpr int kVecs = kWarps * kVecPerWarp;            // 16 per block
constexpr int kKeys = 32;                              // keys per smem tile
constexpr int kMaxD = 128;
constexpr int kMaxD4 = kMaxD / 4;
constexpr int kLanesPerVec = 32 / kVecPerWarp;         // 8
constexpr int kChunksPerLane = kMaxD4 / kLanesPerVec;  // float4 acc / lane
constexpr int kMaxStride4 = kMaxD4 + 1;                // odd float4 stride
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, const int* __restrict__ q_starts,
    const int* __restrict__ q_lens, const int* __restrict__ pos0,
    float* __restrict__ out, int T, int H, int Hkv, int D, int page_size,
    int S, int n_pages, int window, float scale) {
  __shared__ __align__(16) float4 sK[kKeys * kMaxStride4];
  __shared__ __align__(16) float4 sV[kKeys * kMaxStride4];
  __shared__ __align__(16) float4 sQ[kVecs * kMaxD4];
  __shared__ float sP[kVecs][kKeys + 1];
  __shared__ int sSeq, sTile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hk = blockIdx.y;
  const int G = H / Hkv;
  const int rows_per_tile = kVecs / G;
  const int D4 = D / 4;
  const int stride4 = D4 | 1;  // odd: conflict-free 16-byte smem accesses
  const int b = blockIdx.x;

  // ---- which (sequence, row tile) is this block's: scan tile counts ----
  if (tid == 0) sSeq = -1;
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const int ql = s < S ? q_lens[s] : 0;
      const int nt = ql > 0 ? (ql + rows_per_tile - 1) / rows_per_tile : 0;
      int inc = nt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += y;
      }
      const int first = base + inc - nt;
      if (nt > 0 && b >= first && b < first + nt) {
        sSeq = s;
        sTile = b - first;
      }
      base += __shfl_sync(kFull, inc, 31);
      if (base > b) break;  // uniform: base is the same in every lane
    }
  }
  __syncthreads();
  const int s = sSeq;
  if (s < 0) return;  // past the last tile of the step

  const int q_start = q_starts[s];
  const int q_len = q_lens[s];
  const int ctx = context_lens[s];
  const int p0 = pos0[s];
  const int r0 = q_start + sTile * rows_per_tile;
  const int r_end = min(min(q_start + q_len, r0 + rows_per_tile), T);
  const int n_vec = max(r_end - r0, 0) * G;  // vector v: row r0 + v / G

  // ---- query tile into shared memory (zeros past the tile's rows) ----
  for (int i = tid; i < kVecs * D4; i += kThreads) {
    const int v = i / D4, c = i % D4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (v < n_vec) {
      const int row = r0 + v / G, head = hk * G + v % G;
      val = reinterpret_cast<const float4*>(q + ((size_t)row * H + head) * D)[c];
    }
    sQ[v * D4 + c] = val;
  }

  // ---- the keys any row of the tile can see ----
  const int qpos_first = p0 + (r0 - q_start);
  const int qpos_last = p0 + (r_end - 1 - q_start);
  const int kv_end = min(ctx, qpos_last + 1);
  const int kv_begin = window > 0 ? max(0, qpos_first - window + 1) : 0;

  // this warp's query vectors: softmax state, replicated across lanes
  const bool warp_active = warp * kVecPerWarp < n_vec;
  float m_i[kVecPerWarp], l_i[kVecPerWarp], alpha_i[kVecPerWarp];
  int qpos_v[kVecPerWarp];
  bool valid_v[kVecPerWarp];
#pragma unroll
  for (int r = 0; r < kVecPerWarp; ++r) {
    const int v = warp * kVecPerWarp + r;
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
    alpha_i[r] = 1.f;
    valid_v[r] = v < n_vec;
    qpos_v[r] = p0 + (r0 + v / G - q_start);
  }
  // output mapping: lane serves vector vo, float4 chunks lane%8 + 8*cc
  const int vo_local = lane / kLanesPerVec;
  const int vo = warp * kVecPerWarp + vo_local;
  const int c_lane = lane % kLanesPerVec;
  float4 acc[kChunksPerLane];
#pragma unroll
  for (int cc = 0; cc < kChunksPerLane; ++cc)
    acc[cc] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kb = kv_begin; kb < kv_end; kb += kKeys) {
    const int nk = min(kKeys, kv_end - kb);
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    for (int i = tid; i < kKeys * D4; i += kThreads) {
      const int j = i / D4, c = i % D4;
      float4 kval = make_float4(0.f, 0.f, 0.f, 0.f), vval = kval;
      if (j < nk) {  // only keys below context_len are ever loaded
        const int kv = kb + j;
        const int pg = block_tables[(size_t)s * n_pages + kv / page_size];
        const size_t off =
            (((size_t)pg * page_size + kv % page_size) * Hkv + hk) * D;
        kval = reinterpret_cast<const float4*>(k_pages + off)[c];
        vval = reinterpret_cast<const float4*>(v_pages + off)[c];
      }
      sK[j * stride4 + c] = kval;
      sV[j * stride4 + c] = vval;
    }
    __syncthreads();
    if (!warp_active) continue;  // warp-uniform

    // scores of key kb + lane against the warp's vectors
    const int kv = kb + lane;
    float sc[kVecPerWarp];
#pragma unroll
    for (int r = 0; r < kVecPerWarp; ++r) sc[r] = 0.f;
    if (lane < nk) {
      const float4* kr = sK + lane * stride4;
      const float4* qw = sQ + warp * kVecPerWarp * D4;
      for (int c = 0; c < D4; ++c) {
        const float4 kk = kr[c];
#pragma unroll
        for (int r = 0; r < kVecPerWarp; ++r) {
          const float4 qq = qw[r * D4 + c];
          sc[r] = fmaf(qq.x, kk.x, sc[r]);
          sc[r] = fmaf(qq.y, kk.y, sc[r]);
          sc[r] = fmaf(qq.z, kk.z, sc[r]);
          sc[r] = fmaf(qq.w, kk.w, sc[r]);
        }
      }
    }
    // online softmax: row max and sum across the warp's 32 keys
#pragma unroll
    for (int r = 0; r < kVecPerWarp; ++r) {
      const bool ok = valid_v[r] && lane < nk && kv <= qpos_v[r] &&
                      (window <= 0 || qpos_v[r] - kv < window);
      const float sv = ok ? sc[r] * scale : kNegInf;
      const float m_new = fmaxf(m_i[r], warp_max(sv));
      const float alpha = expf(m_i[r] - m_new);
      const float p = ok ? expf(sv - m_new) : 0.f;
      l_i[r] = l_i[r] * alpha + warp_sum(p);
      m_i[r] = m_new;
      alpha_i[r] = alpha;
      sP[warp * kVecPerWarp + r][lane] = p;
    }
    __syncwarp();

    // acc = acc * alpha + P . V for this lane's vector and chunks
    float a = 1.f;
#pragma unroll
    for (int r = 0; r < kVecPerWarp; ++r)
      if (r == vo_local) a = alpha_i[r];
#pragma unroll
    for (int cc = 0; cc < kChunksPerLane; ++cc) {
      acc[cc].x *= a;
      acc[cc].y *= a;
      acc[cc].z *= a;
      acc[cc].w *= a;
    }
    for (int j = 0; j < nk; ++j) {
      const float p = sP[vo][j];
      const float4* vr = sV + j * stride4;
#pragma unroll
      for (int cc = 0; cc < kChunksPerLane; ++cc) {
        const int c = c_lane + cc * kLanesPerVec;
        if (c < D4) {
          const float4 vv = vr[c];
          acc[cc].x = fmaf(p, vv.x, acc[cc].x);
          acc[cc].y = fmaf(p, vv.y, acc[cc].y);
          acc[cc].z = fmaf(p, vv.z, acc[cc].z);
          acc[cc].w = fmaf(p, vv.w, acc[cc].w);
        }
      }
    }
  }

  if (vo >= n_vec) return;
  float l = 0.f;
#pragma unroll
  for (int r = 0; r < kVecPerWarp; ++r)
    if (r == vo_local) l = l_i[r];
  const float denom = fmaxf(l, 1e-30f);
  const int row = r0 + vo / G, head = hk * G + vo % G;
  float4* orow = reinterpret_cast<float4*>(out + ((size_t)row * H + head) * D);
#pragma unroll
  for (int cc = 0; cc < kChunksPerLane; ++cc) {
    const int c = c_lane + cc * kLanesPerVec;
    if (c < D4)
      orow[c] = make_float4(acc[cc].x / denom, acc[cc].y / denom,
                            acc[cc].z / denom, acc[cc].w / denom);
  }
}

}  // namespace

// Plain C launcher (bound with ctypes). Shapes: q/out (T, H, D); pools
// (P, page_size, Hkv, D); block_tables (S, n_pages); the four (S,) int32
// arrays. window <= 0 means no window. The wrapper checks that D % 4 == 0,
// D <= 128, H % Hkv == 0 and 16 % (H / Hkv) == 0, and that q, the pools
// and out are 16-byte aligned. Returns the cudaError_t of cudaGetLastError() right
// after the launch.
extern "C" int paged_attention_ragged_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* block_tables, const int* context_lens, const int* q_starts,
    const int* q_lens, const int* pos0, float* out, int T, int H, int Hkv,
    int D, int page_size, int S, int n_pages, int window, float scale,
    void* stream) {
  const int rows_per_tile = kVecs / (H / Hkv);
  // every sequence's tiles: sum ceil(q_len / rows) <= T / rows + S
  const dim3 grid((T + rows_per_tile - 1) / rows_per_tile + S, Hkv);
  ragged_paged_attention_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      q, k_pages, v_pages, block_tables, context_lens, q_starts, q_lens,
      pos0, out, T, H, Hkv, D, page_size, S, n_pages, window, scale);
  return static_cast<int>(cudaGetLastError());
}
