// One block's tile of paged attention, shared by the ragged kernels
// (ragged_kernel.cuh: paged_attention_ragged.cu in fp32 and
// paged_attention_ragged_quant.cu in int8 / fp8-e4m3) and the batched
// kernel (paged_attention.cu, fp32).
//
// A tile is up to kVecs = 16 query vectors of one sequence and one KV head:
// n_rows consecutive query rows (rows H * D floats apart, from q_rows) times
// the G = H / Hkv query heads of KV head hk, as the Pallas kernels pack
// them, so a K/V row loaded once into shared memory serves all of them.
// Row r sits at global position qpos0 + r and sees every kv_pos with
// kv_pos < ctx, kv_pos <= qpos0 + r and, with window > 0, qpos0 + r - kv_pos
// < window, through table[kv_pos / page_size]. It writes every one of its
// vectors to out_rows (laid out like q_rows); a vector with no visible key
// gets 0.
//
// The key loop runs from the window's first key of row 0 to
// min(ctx, last row + 1, n_pages * page_size) in tiles of kKeys, and loads
// only those keys: slots outside that range (garbage after allocator
// reuse) never reach the sum, not even multiplied by 0. Warp w owns
// vectors 4w..4w+3: lane j scores key j against them (row max and sum are
// warp shuffles), then 8 lanes per vector accumulate P.V over D in float4
// registers. Online softmax in fp32 with expf; out = acc / max(l, 1e-30)
// as in the Pallas flush. K/V rows land in shared memory as float4 with
// an odd float4 stride (conflict-free for D = 80, not a power of two).
//
// The pool element type T is float, int8_t or __nv_fp8_e4m3. Only the K/V
// load differs: a quantized row moves as 4-byte groups of 4 values (D
// bytes instead of 4 D), is widened to float4 and multiplied by the row's
// f32 scale, k = float(k_q) * k_scale[row], as the JAX kernel dequantizes
// after its DMA (DESIGN.md §14); everything after the load is the fp32
// tile. The scales of a tile's keys are read once per key, through
// stable[kv_pos / page_size], into shared memory before the barrier that
// precedes each key tile; the tile's value groups are loaded into
// registers before that barrier too, so scales and values arrive in one
// round trip to device memory, and are widened and scaled after it. For
// T = float the scale arguments are unused and `if constexpr` keeps every
// scale operation out of the code, so the fp32 kernels keep their
// arithmetic and their load loop.
//
// Every thread of the block must call attend_tile (it synchronises).
#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace attn_tile {

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

// 4 quantized values (one 4-byte group of a row, lowest byte first)
// widened to fp32 and times the row's scale s.
__device__ __forceinline__ float4 widen4(uint32_t g, float s, int8_t) {
  return make_float4(static_cast<float>(static_cast<int8_t>(g)) * s,
                     static_cast<float>(static_cast<int8_t>(g >> 8)) * s,
                     static_cast<float>(static_cast<int8_t>(g >> 16)) * s,
                     static_cast<float>(static_cast<int8_t>(g >> 24)) * s);
}

__device__ __forceinline__ float4 widen4(uint32_t g, float s, __nv_fp8_e4m3) {
  __nv_fp8x4_e4m3 v;
  v.__x = g;
  const float4 f = static_cast<float4>(v);
  return make_float4(f.x * s, f.y * s, f.z * s, f.w * s);
}

// k_scales / v_scales: (Ps, page_size, Hkv) f32 scale pools and stable the
// scale table parallel to table; read only when T is a quantized type.
template <typename T>
__device__ __forceinline__ void attend_tile(
    const float* __restrict__ q_rows, float* __restrict__ out_rows,
    int n_rows, int qpos0, int ctx, const int* __restrict__ table,
    int n_pages, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ stable,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    int H, int Hkv, int D, int page_size, int hk, int window, float scale) {
  constexpr bool kQuant = !std::is_same<T, float>::value;
  __shared__ __align__(16) float4 sK[kKeys * kMaxStride4];
  __shared__ __align__(16) float4 sV[kKeys * kMaxStride4];
  __shared__ __align__(16) float4 sQ[kVecs * kMaxD4];
  __shared__ float sP[kVecs][kKeys + 1];
  __shared__ float sKs[kKeys], sVs[kKeys];  // the tile's K/V row scales

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = H / Hkv;
  const int D4 = D / 4;
  const int stride4 = D4 | 1;  // odd: conflict-free 16-byte smem accesses
  const int n_vec = n_rows * G;  // vector v: row v / G, head hk * G + v % G

  // ---- query tile into shared memory (zeros past the tile's rows) ----
  for (int i = tid; i < kVecs * D4; i += kThreads) {
    const int v = i / D4, c = i % D4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (v < n_vec) {
      const int head = hk * G + v % G;
      val = reinterpret_cast<const float4*>(
          q_rows + ((size_t)(v / G) * H + head) * D)[c];
    }
    sQ[v * D4 + c] = val;
  }

  // ---- the keys any row of the tile can see ----
  const int kv_end =
      min(min(ctx, qpos0 + n_rows), n_pages * page_size);
  const int kv_begin = window > 0 ? max(0, qpos0 - window + 1) : 0;

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
    qpos_v[r] = qpos0 + v / G;
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
    if constexpr (kQuant) {
      // values into registers and scales into shared memory, all issued
      // before the barrier (the previous tile's load loop ended at the
      // barrier below it, so the scale slots are free again)
      constexpr int kPer = kKeys * kMaxD4 / kThreads;  // groups / thread
      uint32_t gk[kPer], gv[kPer];
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int i = tid + n * kThreads;
        const int j = i / D4, c = i % D4;
        gk[n] = gv[n] = 0u;
        if (i < kKeys * D4 && j < nk) {  // only keys below kv_end
          const int kv = kb + j;
          const size_t off = (((size_t)table[kv / page_size] * page_size +
                               kv % page_size) * Hkv + hk) * D;
          gk[n] = reinterpret_cast<const uint32_t*>(k_pages + off)[c];
          gv[n] = reinterpret_cast<const uint32_t*>(v_pages + off)[c];
        }
      }
      if (tid < nk) {
        const int kv = kb + tid;
        const size_t row =
            ((size_t)stable[kv / page_size] * page_size + kv % page_size) *
                Hkv + hk;
        sKs[tid] = k_scales[row];
        sVs[tid] = v_scales[row];
      }
      __syncthreads();  // the previous tile is consumed, the scales are in
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int i = tid + n * kThreads;
        const int j = i / D4, c = i % D4;
        if (i < kKeys * D4) {
          float4 kval = make_float4(0.f, 0.f, 0.f, 0.f), vval = kval;
          if (j < nk) {
            kval = widen4(gk[n], sKs[j], T{});
            vval = widen4(gv[n], sVs[j], T{});
          }
          sK[j * stride4 + c] = kval;
          sV[j * stride4 + c] = vval;
        }
      }
    } else {
      __syncthreads();  // the previous tile is consumed (and sQ is written)
      for (int i = tid; i < kKeys * D4; i += kThreads) {
        const int j = i / D4, c = i % D4;
        float4 kval = make_float4(0.f, 0.f, 0.f, 0.f), vval = kval;
        if (j < nk) {  // only keys below kv_end are ever loaded
          const int kv = kb + j;
          const int pg = table[kv / page_size];
          const size_t off =
              (((size_t)pg * page_size + kv % page_size) * Hkv + hk) * D;
          kval = reinterpret_cast<const float4*>(k_pages + off)[c];
          vval = reinterpret_cast<const float4*>(v_pages + off)[c];
        }
        sK[j * stride4 + c] = kval;
        sV[j * stride4 + c] = vval;
      }
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
  const int head = hk * G + vo % G;
  float4* orow = reinterpret_cast<float4*>(
      out_rows + ((size_t)(vo / G) * H + head) * D);
#pragma unroll
  for (int cc = 0; cc < kChunksPerLane; ++cc) {
    const int c = c_lane + cc * kLanesPerVec;
    if (c < D4)
      orow[c] = make_float4(acc[cc].x / denom, acc[cc].y / denom,
                            acc[cc].z / denom, acc[cc].w / denom);
  }
}

}  // namespace attn_tile
