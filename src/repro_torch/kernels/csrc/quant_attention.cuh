// The body of kernel B2 (paged_attention_ragged_quant.cu): token-packed
// ragged paged attention over int8 or fp8-e4m3 K/V pools with f32 row
// scales, templated over the value type T (int8_t, __nv_fp8_e4m3) and the
// copy width CH (16 bytes when D % 16 == 0 and the pools are 16-byte
// aligned, else 4).
//
// Contract (repro_torch/kernels/ref.py::paged_attention_ragged_quant_ref):
// sequence s owns packed rows [q_starts[s], q_starts[s] + q_lens[s]); row t
// sits at q_pos = pos0[s] + t - q_starts[s] and attends to every kv_pos with
// kv_pos < context_lens[s], kv_pos <= q_pos and, with a window, q_pos -
// kv_pos < window, reading K/V through block_tables[s, kv_pos / page] and
// the row scales through scale_tables[s, kv_pos / page]. A row with no
// visible key gives 0; rows no sequence owns are left alone (the wrapper
// hands in a zeroed output). A tile's vectors are its rows times the G =
// H / Hkv query heads of one KV head, as the Pallas kernel packs them.
//
// A sequence whose rows x G fit dec_vecs = max(4, G) vectors is a decode
// tile (a decode row; at G <= 2 a few rows); every other sequence is cut
// into chunk tiles of kChunkVecs (64) vectors. Three launches, with grids
// and scratch from host-known sizes only (T, S, the table's n_pages *
// page and G; nothing is read back). The KV head is the fastest grid
// index: the Hkv blocks of one sequence and split (or tile) run together
// and read whole token rows of the pools ((P, page, Hkv, D): a token's
// heads are adjacent), not one head's 1/Hkv of each.
//
// 1. decode_split_kernel, grid S * n_splits * Hkv: the keys are cut at
//    fixed multiples of split_keys, and each block takes one (decode tile,
//    KV head, split). Its 4 warps take 32-key sub-tiles in turn; each warp
//    streams its sub-tiles' raw 1-byte K/V rows and f32 scales by cp.async
//    through its own 2-stage ring and widens them in registers (widen4:
//    integer and fp32 ops, no conversion unit): lane j scores key j
//    against the tile's vectors (q in shared memory), then lane c
//    accumulates P.V for output values 4c..4c+3, four keys a step, the
//    key's scale folded into its score and into its p. The tile size is a
//    template parameter (4, 8 or 16 vectors), so a decode row's loops hold
//    no idle vectors. The warps' (m, l, acc) are merged in shared memory
//    in warp order, and the split writes (out, lse) for each vector to
//    scratch; a vector that sees no key of the split writes (0, -1e30),
//    which weighs nothing in the merge.
// 2. chunk_tile_kernel, grid (ceil(T / rows) + S) * Hkv: blocks find their (sequence, chunk tile) by a warp scan over q_lens,
//    a sequence's last tile (the one with the most keys) first. Key tiles
//    of 64 arrive by cp.async, are widened and scaled once into fp32
//    shared memory (k = float(k_q) * k_scale, as the JAX kernel
//    dequantizes after its DMA), and each thread holds a 4-vector x 8-key
//    micro-tile of S = Q K^T (12 LDS.128 for 128 FMAs) and a 4-vector x
//    16-value tile of O += P V; row max and sum, and each key's p for P V,
//    are shuffles among the 8 threads of a row. One raw stage and no P
//    tile in shared memory let three blocks share an SM.
// 3. merge_splits_kernel, grid S * Hkv: each decode tile's vectors merge
//    the splits their keys reach, in split order, as
//    merge_partial_attention does (src/repro/models/attention.py).
//
// Only keys in [the window's first key, min(ctx, last row + 1, n_pages *
// page)) are ever copied, so slots outside a sequence's visible range
// (garbage after allocator reuse, poison) never reach a sum. Every output
// is a fixed-order sum: no atomics, a second launch is bitwise equal.
#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace quant_attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSubKeys = 32;    // keys of a warp's decode sub-tile
constexpr int kChunkVecs = 64;  // query vectors of a chunk tile
constexpr int kChunkKeys = 64;  // keys of a chunk tile's key tile
static_assert(kChunkKeys == 16 * kWarps, "a warp copies 16 keys a tile");
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

// 4 quantized values (one 4-byte group, lowest byte first) widened to fp32
// exactly, by integer and fp32 ops only (the conversion units run at a
// fraction of the FMA rate). int8: the byte + 128 placed in the low
// mantissa of 2^23 gives 2^23 + 128 + b. fp8-e4m3: sign, exponent and
// mantissa moved into fp32's fields give the value times 2^-120
// (subnormals included); the two NaN codes come out finite, and no code
// gives an infinity, so bytes a tile never copied stay harmless.
__device__ __forceinline__ float4 widen4(uint32_t g, int8_t) {
  const uint32_t u = g ^ 0x80808080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  return make_float4(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBias,
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBias,
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBias,
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBias);
}

__device__ __forceinline__ float e4m3_byte(uint32_t g, int sel) {
  const int top = static_cast<int>(__byte_perm(g, 0u, sel));  // byte << 24
  return __int_as_float((top >> 4) & static_cast<int>(0x87F00000u)) *
         0x1p120f;
}

__device__ __forceinline__ float4 widen4(uint32_t g, __nv_fp8_e4m3) {
  return make_float4(e4m3_byte(g, 0x0444), e4m3_byte(g, 0x1444),
                     e4m3_byte(g, 0x2444), e4m3_byte(g, 0x3444));
}

template <int CH>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (CH == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes between two raw K (or V) rows in shared memory: D rounded to an odd
// number of copies, so lanes reading one row each hit distinct banks.
__host__ __device__ constexpr int raw_stride(int D, int CH) {
  return ((D / CH) | 1) * CH;
}

// One stage of raw keys: nk K rows, nk V rows, nk K and nk V scales.
__host__ __device__ constexpr int stage_bytes(int nk, int rs) {
  return nk * (2 * rs + 8);
}

struct Raw {
  uint8_t* k;
  uint8_t* v;
  float* ks;
  float* vs;
};

__device__ __forceinline__ Raw raw_at(uint8_t* base, int nk, int rs) {
  float* scales = reinterpret_cast<float*>(base + 2 * nk * rs);
  return {base, base + nk * rs, scales, scales + nk};
}

// What a step's sequence s and KV head hk see: pools, tables, geometry.
template <typename T>
struct Pools {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  const int* table;   // block_tables[s]
  const int* stable;  // scale_tables[s]
  int page, Hkv, hk, D;
};

// Keys k0..k0+nk-1 (nk <= 32) into rows j0.. of stage r by one warp's
// cp.async: lane j reads key j's entries of both tables once, and every
// copy takes its row by shuffle, so no copy waits on a table read of its
// own. The caller commits.
template <typename T, int CH>
__device__ __forceinline__ void load_keys(const Raw& r, int rs, int k0,
                                          int nk, int j0, int lane,
                                          const Pools<T>& p) {
  unsigned long long row = 0;  // key lane's K/V row, in elements
  if (lane < nk) {
    const int kv = k0 + lane, pg = kv / p.page, slot = kv % p.page;
    row = (((unsigned long long)p.table[pg] * p.page + slot) * p.Hkv +
           p.hk) * p.D;
    const size_t srow =
        ((size_t)p.stable[pg] * p.page + slot) * p.Hkv + p.hk;
    cp_async<4>(r.ks + j0 + lane, p.ks + srow);
    cp_async<4>(r.vs + j0 + lane, p.vs + srow);
  }
  const int cpr = p.D / CH, n = nk * cpr;
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(p.k);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(p.v);
  for (int i0 = 0; i0 < n; i0 += 32) {  // the same trip count in every lane
    const int i = i0 + lane, j = min(i / cpr, 31), c = i % cpr;
    const unsigned long long off = __shfl_sync(kFull, row, j) + c * CH;
    if (i < n) {
      const int d = (j0 + j) * rs + c * CH;
      cp_async<CH>(r.k + d, kb + off);
      cp_async<CH>(r.v + d, vb + off);
    }
  }
}

// The key range [begin, end) the rows [qpos0, qpos0 + n_rows) of a tile
// can see, below the table's n_keys.
struct KeyRange {
  int begin, end;
};

__device__ __forceinline__ KeyRange visible(int qpos0, int n_rows, int ctx,
                                            int n_keys, int window) {
  return {window > 0 ? max(0, qpos0 - window + 1) : 0,
          min(min(ctx, qpos0 + n_rows), n_keys)};
}

// Shared memory of decode_split_kernel for NV-vector tiles: q of the tile,
// each warp's p values, the warps' m and l, then each warp's 2-stage ring
// (the warps' accumulators reuse the rings once every key is consumed).
__host__ __device__ constexpr int decode_smem(int D, int CH, int NV) {
  return NV * D * 4 + kWarps * NV * kSubKeys * 4 + 2 * kWarps * NV * 4 +
         kWarps * 2 * stage_bytes(kSubKeys, raw_stride(D, CH));
}

template <typename T, int CH, int NV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const float* __restrict__ ksp,
                    const float* __restrict__ vsp,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ scale_tables,
                    const int* __restrict__ context_lens,
                    const int* __restrict__ q_starts,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ pos0, float* __restrict__ part_o,
                    float* __restrict__ part_lse, int T_rows, int H, int Hkv,
                    int D, int page, int n_pages, int window, float scale,
                    int n_splits, int split_keys) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = H / Hkv;
  const int hk = blockIdx.x % Hkv;  // heads fastest: whole token rows
  const int s = blockIdx.x / Hkv / n_splits, sp = blockIdx.x / Hkv % n_splits;
  const int q_len = q_lens[s];
  if (q_len <= 0 || q_len * G > NV) return;  // a chunk or pad seq
  const int q_start = q_starts[s];
  const int n_rows = min(q_len, T_rows - q_start);
  if (n_rows <= 0) return;
  const int qpos0 = pos0[s];
  const KeyRange vis =
      visible(qpos0, n_rows, context_lens[s], n_pages * page, window);
  const int lo = max(vis.begin, sp * split_keys);
  const int hi = min(vis.end, (sp + 1) * split_keys);
  if (lo >= hi) return;  // the merge reads only splits with keys

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_vec = n_rows * G, D4 = D / 4;
  const int rs = raw_stride(D, CH), stage = stage_bytes(kSubKeys, rs);
  float* sQ = reinterpret_cast<float*>(smem);
  float* sP = sQ + NV * D;
  float* sM = sP + kWarps * NV * kSubKeys;
  float* sL = sM + kWarps * NV;
  uint8_t* ring = reinterpret_cast<uint8_t*>(sL + kWarps * NV);
  uint8_t* mine = ring + warp * 2 * stage;
  const Pools<T> pools{kp, vp, ksp, vsp,
                       block_tables + (size_t)s * n_pages,
                       scale_tables + (size_t)s * n_pages, page, Hkv, hk, D};

  // this warp's sub-tiles: keys from lo + 32 (warp + 4 i), i < n_mine
  const int n_sub = (hi - lo + kSubKeys - 1) / kSubKeys;
  const int n_mine = n_sub > warp ? (n_sub - warp + kWarps - 1) / kWarps : 0;
  const auto prefetch = [&](int i) {
    if (i < n_mine) {
      const int k0 = lo + kSubKeys * (warp + kWarps * i);
      load_keys<T, CH>(raw_at(mine + (i % 2) * stage, kSubKeys, rs), rs, k0,
                       min(kSubKeys, hi - k0), 0, lane, pools);
    }
    commit();
  };
  prefetch(0);
  prefetch(1);
  // q of the tile's vectors, zeros past n_vec (their scores are masked)
  for (int i = tid; i < NV * D4; i += kThreads) {
    const int v = i / D4, c = i % D4;
    reinterpret_cast<float4*>(sQ)[i] =
        v < n_vec ? reinterpret_cast<const float4*>(
                        q + ((size_t)(q_start + v / G) * H + hk * G + v % G) *
                                D)[c]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // per vector: m (the same in every lane), this lane's share of l, and
  // this lane's 4 output values 4 * lane.. (lanes below D / 4)
  float m[NV], l[NV], acc[NV][4];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    m[v] = kNegInf;
    l[v] = 0.f;
    acc[v][0] = acc[v][1] = acc[v][2] = acc[v][3] = 0.f;
  }
  float* pw = sP + warp * NV * kSubKeys;
  for (int i = 0; i < n_mine; ++i) {
    wait_pending<1>();
    __syncwarp();  // every lane's copies of stage i % 2 are in
    const Raw r = raw_at(mine + (i % 2) * stage, kSubKeys, rs);
    const int kb = lo + kSubKeys * (warp + kWarps * i);
    const int nk = min(kSubKeys, hi - kb);
    const int kv = kb + lane;
    const bool kvalid = lane < nk;

    // scores of key kv (this lane) against every vector; a lane past nk
    // reads bytes no copy wrote (finite once widened) and is masked below
    float sc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) sc[v] = 0.f;
    const uint8_t* krow = r.k + lane * rs;
    for (int c = 0; c < D; c += CH) {
      float kf[CH];
      if constexpr (CH == 16) {
        const uint4 g = *reinterpret_cast<const uint4*>(krow + c);
        const float4 f[4] = {widen4(g.x, T{}), widen4(g.y, T{}),
                             widen4(g.z, T{}), widen4(g.w, T{})};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          kf[4 * u] = f[u].x;
          kf[4 * u + 1] = f[u].y;
          kf[4 * u + 2] = f[u].z;
          kf[4 * u + 3] = f[u].w;
        }
      } else {
        const float4 f =
            widen4(*reinterpret_cast<const uint32_t*>(krow + c), T{});
        kf[0] = f.x;
        kf[1] = f.y;
        kf[2] = f.z;
        kf[3] = f.w;
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4* qv = reinterpret_cast<const float4*>(sQ + v * D + c);
#pragma unroll
        for (int u = 0; u < CH / 4; ++u) {
          const float4 qq = qv[u];
          sc[v] = fmaf(qq.x, kf[4 * u], sc[v]);
          sc[v] = fmaf(qq.y, kf[4 * u + 1], sc[v]);
          sc[v] = fmaf(qq.z, kf[4 * u + 2], sc[v]);
          sc[v] = fmaf(qq.w, kf[4 * u + 3], sc[v]);
        }
      }
    }
    const float k_sc = kvalid ? r.ks[lane] * scale : 0.f;
    const float v_sc = kvalid ? r.vs[lane] : 0.f;

    // online softmax over the sub-tile's keys; p * v_scale to shared
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int qp = qpos0 + v / G;
      const bool ok = v < n_vec && kvalid && kv <= qp &&
                      (window <= 0 || qp - kv < window);
      const float sv = ok ? sc[v] * k_sc : kNegInf;
      const float m_new = fmaxf(m[v], warp_max(sv));
      const float alpha = expf(m[v] - m_new);
      const float p = ok ? expf(sv - m_new) : 0.f;
      m[v] = m_new;
      l[v] = l[v] * alpha + p;
      acc[v][0] *= alpha;
      acc[v][1] *= alpha;
      acc[v][2] *= alpha;
      acc[v][3] *= alpha;
      pw[v * kSubKeys + lane] = p * v_sc;
    }
    __syncwarp();

    // acc += P . V, 4 keys at a time: values 4 * lane.. (p is 0 past nk,
    // where the widened bytes are finite)
    if (lane < D4) {
      const uint8_t* vcol = r.v + 4 * lane;
      for (int j = 0; j < nk; j += 4) {
        float4 vf[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vf[u] = widen4(
              *reinterpret_cast<const uint32_t*>(vcol + (j + u) * rs), T{});
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              pw + v * kSubKeys + j);
          const float pu[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[v][0] = fmaf(pu[u], vf[u].x, acc[v][0]);
            acc[v][1] = fmaf(pu[u], vf[u].y, acc[v][1]);
            acc[v][2] = fmaf(pu[u], vf[u].z, acc[v][2]);
            acc[v][3] = fmaf(pu[u], vf[u].w, acc[v][3]);
          }
        }
      }
    }
    __syncwarp();  // stage i % 2 and pw are free again
    prefetch(i + 2);
  }
  wait_pending<0>();

  // merge the warps in order: M = max m, L = sum l e^(m - M), O likewise
#pragma unroll
  for (int v = 0; v < NV; ++v) l[v] = warp_sum(l[v]);
  __syncthreads();  // every ring is consumed: reuse it for the accumulators
  float* accW = reinterpret_cast<float*>(ring);  // [warp][vector][D]
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (lane < D4)
      reinterpret_cast<float4*>(accW + (warp * NV + v) * D)[lane] =
          make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
    if (lane == 0) {
      sM[warp * NV + v] = m[v];
      sL[warp * NV + v] = l[v];
    }
  }
  __syncthreads();
  for (int i = tid; i < n_vec * D; i += kThreads) {
    const int v = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sM[w * NV + v]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sM[w * NV + v] - M);
      L = fmaf(sL[w * NV + v], f, L);
      O = fmaf(accW[(w * NV + v) * D + d], f, O);
    }
    const size_t idx = (((size_t)s * n_splits + sp) * Hkv + hk) * NV + v;
    part_o[idx * D + d] = L > 0.f ? O / L : 0.f;
    if (d == 0) part_lse[idx] = L > 0.f ? M + logf(L) : kNegInf;
  }
}

// The (sequence, chunk tile) of chunk block b: a warp scan over q_lens of
// the sequences' chunk-tile counts, a sequence's last tile (the one with
// the most keys) first; x = -1 past the last tile. Every thread of the
// block calls it (it synchronises).
__device__ __forceinline__ int2 find_chunk_tile(const int* __restrict__ q_lens,
                                                int S, int G, int dec_vecs,
                                                int rows_per_tile, int b) {
  __shared__ int sSeq, sTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) sSeq = -1;
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const int ql = s < S ? q_lens[s] : 0;
      const int nt =
          ql * G > dec_vecs ? (ql + rows_per_tile - 1) / rows_per_tile : 0;
      int inc = nt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += y;
      }
      const int first = base + inc - nt;
      if (nt > 0 && b >= first && b < first + nt) {
        sSeq = s;
        sTile = first + nt - 1 - b;
      }
      base += __shfl_sync(kFull, inc, 31);
      if (base > b) break;  // uniform: base is the same in every lane
    }
  }
  __syncthreads();
  return make_int2(sSeq, sTile);
}

__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const float* __restrict__ part_o,
                    const float* __restrict__ part_lse,
                    const int* __restrict__ context_lens,
                    const int* __restrict__ q_starts,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ pos0, float* __restrict__ out,
                    int T_rows, int H, int Hkv, int D, int page, int n_pages,
                    int window, int n_splits, int split_keys, int dec_vecs) {
  const int G = H / Hkv;
  const int s = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int q_len = q_lens[s];
  if (q_len <= 0 || q_len * G > dec_vecs) return;
  const int q_start = q_starts[s];
  const int n_rows = min(q_len, T_rows - q_start);
  if (n_rows <= 0) return;
  const KeyRange vis =
      visible(pos0[s], n_rows, context_lens[s], n_pages * page, window);
  if (vis.begin >= vis.end) return;  // no key: the rows stay 0
  const int sp0 = vis.begin / split_keys, sp1 = (vis.end - 1) / split_keys;
  for (int i = threadIdx.x; i < n_rows * G * D; i += kThreads) {
    const int v = i / D, d = i % D;
    const size_t base = ((size_t)s * n_splits * Hkv + hk) * dec_vecs + v;
    const size_t step = (size_t)Hkv * dec_vecs;  // one split further
    float M = kNegInf;
    for (int sp = sp0; sp <= sp1; ++sp)
      M = fmaxf(M, part_lse[base + sp * step]);
    float num = 0.f, den = 0.f;
    for (int sp = sp0; sp <= sp1; ++sp) {
      const float w = expf(part_lse[base + sp * step] - M);
      den += w;
      num = fmaf(part_o[(base + sp * step) * D + d], w, num);
    }
    out[((size_t)(q_start + v / G) * H + hk * G + v % G) * D + d] =
        num / fmaxf(den, 1e-30f);
  }
}

// Shared memory of chunk_tile_kernel: q, K and V widened (odd float4
// stride), and one stage of raw keys (the next tile's copies land in it
// while this tile's fp32 copy is in use): 72.5 KB at D = 80, so three
// blocks share an SM.
__host__ __device__ constexpr int chunk_smem(int D, int CH) {
  return kChunkVecs * D * 4 + 2 * kChunkKeys * ((D / 4) | 1) * 16 +
         stage_bytes(kChunkKeys, raw_stride(D, CH));
}

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads, 3)
chunk_tile_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const float* __restrict__ ksp,
                  const float* __restrict__ vsp,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ scale_tables,
                  const int* __restrict__ context_lens,
                  const int* __restrict__ q_starts,
                  const int* __restrict__ q_lens,
                  const int* __restrict__ pos0, float* __restrict__ out,
                  int T_rows, int H, int Hkv, int D, int page, int S,
                  int n_pages, int window, float scale, int dec_vecs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / Hkv, rows_per_tile = kChunkVecs / G;
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;

  const int2 st = find_chunk_tile(q_lens, S, G, dec_vecs, rows_per_tile, b);
  const int s = st.x, sTile = st.y;
  if (s < 0) return;  // past the last chunk tile (block-uniform)

  const int q_start = q_starts[s];
  const int r0 = q_start + sTile * rows_per_tile;
  const int n_rows =
      min(min(q_start + q_lens[s], r0 + rows_per_tile), T_rows) - r0;
  if (n_rows <= 0) return;
  const int qpos0 = pos0[s] + (r0 - q_start);
  const KeyRange vis =
      visible(qpos0, n_rows, context_lens[s], n_pages * page, window);
  const int n_vec = n_rows * G, D4 = D / 4, st4 = D4 | 1;
  const int rs = raw_stride(D, CH);
  float4* sQ = reinterpret_cast<float4*>(smem);
  float4* sK = sQ + kChunkVecs * D4;
  float4* sV = sK + kChunkKeys * st4;
  uint8_t* raw = reinterpret_cast<uint8_t*>(sV + kChunkKeys * st4);
  const Pools<T> pools{kp, vp, ksp, vsp,
                       block_tables + (size_t)s * n_pages,
                       scale_tables + (size_t)s * n_pages, page, Hkv, hk, D};
  const int n_kt = vis.end > vis.begin
                       ? (vis.end - vis.begin + kChunkKeys - 1) / kChunkKeys
                       : 0;
  const auto prefetch = [&](int t) {  // warp w copies keys 16w..16w+15
    if (t < n_kt) {
      const int k0 = vis.begin + t * kChunkKeys + 16 * warp;
      const int nk = min(16, vis.end - k0);
      if (nk > 0)  // warp-uniform
        load_keys<T, CH>(raw_at(raw, kChunkKeys, rs), rs, k0, nk, 16 * warp,
                         lane, pools);
    }
    commit();
  };
  prefetch(0);
  for (int i = tid; i < kChunkVecs * D4; i += kThreads) {
    const int v = i / D4, c = i % D4;
    sQ[i] = v < n_vec ? reinterpret_cast<const float4*>(
                            q + ((size_t)(r0 + v / G) * H + hk * G + v % G) *
                                    D)[c]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // thread (tv, tk): vectors tv + 16 i (i < 4); keys tk + 8 j (j < 8) of
  // a key tile in S; output values 4 (tk + 8 cc).. (cc < 4) in O
  const int tv = tid / 8, tk = tid % 8;
  float m[4], l[4];
  int qp[4];
  bool vok[4];
  float4 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = tv + 16 * i;
    m[i] = kNegInf;
    l[i] = 0.f;  // this thread's share: summed over the row's 8 at the end
    vok[i] = v < n_vec;
    qp[i] = qpos0 + v / G;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[i][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < n_kt; ++t) {
    wait_pending<0>();
    __syncthreads();  // key tile t is in; the last tile's P.V is done
    const Raw r = raw_at(raw, kChunkKeys, rs);
    const int kb = vis.begin + t * kChunkKeys;
    const int nk = min(kChunkKeys, vis.end - kb);
    for (int i = tid; i < kChunkKeys * D4; i += kThreads) {
      const int j = i / D4, c = i % D4;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
      if (j < nk) {
        const float a = r.ks[j], bsc = r.vs[j];
        kf = widen4(*reinterpret_cast<const uint32_t*>(r.k + j * rs + 4 * c),
                    T{});
        vf = widen4(*reinterpret_cast<const uint32_t*>(r.v + j * rs + 4 * c),
                    T{});
        kf = make_float4(kf.x * a, kf.y * a, kf.z * a, kf.w * a);
        vf = make_float4(vf.x * bsc, vf.y * bsc, vf.z * bsc, vf.w * bsc);
      }
      sK[j * st4 + c] = kf;
      sV[j * st4 + c] = vf;
    }
    __syncthreads();  // the fp32 tile is ready; the raw stage is consumed
    prefetch(t + 1);

    // S = Q K^T for this thread's 4 x 8 micro-tile
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D4; ++c) {
      float4 qq[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qq[i] = sQ[(tv + 16 * i) * D4 + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = sK[(tk + 8 * j) * st4 + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = fmaf(qq[i].x, kk[j].x, sc[i][j]);
          sc[i][j] = fmaf(qq[i].y, kk[j].y, sc[i][j]);
          sc[i][j] = fmaf(qq[i].z, kk[j].z, sc[i][j]);
          sc[i][j] = fmaf(qq[i].w, kk[j].w, sc[i][j]);
        }
    }

    // online softmax: the row's max over its 8 threads (lanes xor 1, 2, 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
      bool ok[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = tk + 8 * j, kv = kb + key;
        ok[j] = vok[i] && key < nk && kv <= qp[i] &&
                (window <= 0 || qp[i] - kv < window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;  // p, key tk + 8j
        sum += sc[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        acc[i][cc].x *= alpha;
        acc[i][cc].y *= alpha;
        acc[i][cc].z *= alpha;
        acc[i][cc].w *= alpha;
      }
    }
    // O += P V over the tile's keys in order: key 8 jj + kk's p comes from
    // lane kk of this row's 8 (nk is block-uniform: every lane shuffles)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int j = 8 * jj + kk;
        if (j >= nk) break;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = __shfl_sync(kFull, sc[i][jj], (lane & ~7) | kk);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int c = tk + 8 * cc;
          if (c < D4) {
            const float4 vv = sV[j * st4 + c];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][cc].x = fmaf(p[i], vv.x, acc[i][cc].x);
              acc[i][cc].y = fmaf(p[i], vv.y, acc[i][cc].y);
              acc[i][cc].z = fmaf(p[i], vv.z, acc[i][cc].z);
              acc[i][cc].w = fmaf(p[i], vv.w, acc[i][cc].w);
            }
          }
        }
      }
    }
  }
  wait_pending<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(kFull, li, 1);
    li += __shfl_xor_sync(kFull, li, 2);
    li += __shfl_xor_sync(kFull, li, 4);
    const int v = tv + 16 * i;
    if (!vok[i]) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float4* orow = reinterpret_cast<float4*>(
        out + ((size_t)(r0 + v / G) * H + hk * G + v % G) * D);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = tk + 8 * cc;
      if (c < D4)
        orow[c] = make_float4(acc[i][cc].x * inv, acc[i][cc].y * inv,
                              acc[i][cc].z * inv, acc[i][cc].w * inv);
    }
  }
}

// Lets Kernel take `bytes` of dynamic shared memory on the current device:
// one cudaFuncSetAttribute per kernel, device and larger size, not one
// a launch.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static int allowed[64] = {};  // bytes allowed so far, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || bytes <= allowed[dev]) return err;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

// The three launches on `stream` (see the top of this file), decode tiles
// of dec_vecs vectors (4, 8 or 16); part_o and part_lse are the caller's
// scratch (S, n_splits, Hkv, dec_vecs[, D]). Returns the first launch
// error, or 0.
template <typename T, int CH>
int launch(const float* q, const T* kp, const T* vp, const float* ks,
           const float* vs, const int* bt, const int* st, const int* ctx,
           const int* qs, const int* ql, const int* p0, float* out,
           float* part_o, float* part_lse, int T_rows, int H, int Hkv, int D,
           int page, int S, int n_pages, int window, float scale,
           int n_splits, int split_keys, int dec_vecs, int chunk_tiles,
           cudaStream_t stream) {
  const auto decode = [&](auto kernel, cudaError_t allowed, int bytes) {
    if (allowed != cudaSuccess) return allowed;
    kernel<<<S * n_splits * Hkv, kThreads, bytes, stream>>>(
        q, kp, vp, ks, vs, bt, st, ctx, qs, ql, p0, part_o, part_lse, T_rows,
        H, Hkv, D, page, n_pages, window, scale, n_splits, split_keys);
    return cudaGetLastError();
  };
  const int dec = decode_smem(D, CH, dec_vecs);
  cudaError_t err = cudaErrorInvalidValue;  // dec_vecs not 4, 8 or 16
  if (dec_vecs == 4)
    err = decode(decode_split_kernel<T, CH, 4>,
                 allow_smem<decode_split_kernel<T, CH, 4>>(dec), dec);
  if (dec_vecs == 8)
    err = decode(decode_split_kernel<T, CH, 8>,
                 allow_smem<decode_split_kernel<T, CH, 8>>(dec), dec);
  if (dec_vecs == 16)
    err = decode(decode_split_kernel<T, CH, 16>,
                 allow_smem<decode_split_kernel<T, CH, 16>>(dec), dec);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_splits_kernel<<<S * Hkv, kThreads, 0, stream>>>(
      part_o, part_lse, ctx, qs, ql, p0, out, T_rows, H, Hkv, D, page,
      n_pages, window, n_splits, split_keys, dec_vecs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int chk = chunk_smem(D, CH);
  err = allow_smem<chunk_tile_kernel<T, CH>>(chk);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_tile_kernel<T, CH><<<chunk_tiles * Hkv, kThreads, chk, stream>>>(
      q, kp, vp, ks, vs, bt, st, ctx, qs, ql, p0, out, T_rows, H, Hkv, D,
      page, S, n_pages, window, scale, dec_vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace quant_attn
