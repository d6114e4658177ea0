// The attention body of kernels B1 (paged_attention_ragged.cu), B2
// (paged_attention_ragged_quant.cu) and B3 (paged_attention.cu): paged
// attention over K/V pools of T = float, __nv_bfloat16, int8_t or
// __nv_fp8_e4m3 values (the 1-byte types with f32 row scales), for q and
// an output of QT = float or __nv_bfloat16, in one of two layouts, with
// the copy width CH (16 bytes for fp32 and bf16 pools and for 1-byte rows
// of D % 16 == 0 on 16-byte aligned pools, else 4).
//
// bf16, as the Pallas kernels take it (paged_attention.py, which casts
// every block to fp32 and writes the output in q's dtype): q and the pools
// are widened to fp32 exactly (a bf16 is the top half of its fp32: a shift
// or a mask, no conversion unit), every score, softmax sum, accumulator
// and split partial is fp32, and the output is rounded once to nearest
// even (__float2bfloat16_rn, as astype). bf16 pools take the route of the
// 1-byte pools (32-key decode sub-tiles, 64-key chunk tiles widened once
// into fp32 shared memory) without scales; unlike widened bytes, bf16
// bytes a stage never copied may be NaN, so they are masked by selects as
// fp32 rows are.
//
// Layouts (a template parameter: Ragged or Batched, below).
// * Ragged (B1, B2; ref.py::paged_attention_ragged_ref and
//   ::paged_attention_ragged_quant_ref): sequence s owns packed rows
//   [q_starts[s], q_starts[s] + q_lens[s]); row t sits at q_pos = pos0[s] +
//   t - q_starts[s]. Rows no sequence owns are left alone (the wrapper
//   hands in a zeroed output).
// * Batched (B3; ref.py::paged_attention_ref): q (B, Tq, H, D); sequence b
//   owns rows [b Tq, (b + 1) Tq), row t at q_pos = q_starts[b] + t. Every
//   row is written (the wrapper hands in torch.empty_like(q)).
// A row attends to every kv_pos with kv_pos < context_lens[s], kv_pos <=
// q_pos and, with a window, q_pos - kv_pos < window, reading K/V through
// block_tables[s, kv_pos / page] and the row scales through
// scale_tables[s, kv_pos / page]; a row with no visible key gives 0. A
// tile's vectors are its rows times the G = H / Hkv query heads of one KV
// head, as the Pallas kernels pack them.
//
// Tiles. Ragged: a sequence whose rows x G fit dec_vecs = max(4, G)
// vectors is a decode tile, every other one is cut into chunk tiles of
// kChunkVecs (64) vectors. Batched: every sequence has Tq rows, so a call
// is all decode tiles (Tq x G <= 16, rounded up to 4, 8 or 16 vectors) or
// all chunk tiles. Grids and scratch come from host-known sizes only (the
// wrappers' plans, kernels/paged_attention.py; nothing is read back). The
// KV head is the fastest grid index: the Hkv blocks of one tile and split
// run together and read whole token rows of the pools ((P, page, Hkv, D):
// a token's heads are adjacent), not one head's 1/Hkv of each.
//
// 1. decode_split_kernel, grid tiles * n_splits * Hkv: the keys are cut at
//    fixed multiples of split_keys, and each block takes one (decode tile,
//    split, KV head). Its 4 warps take sub-tiles of kSubKeys keys in turn;
//    each warp streams its sub-tiles' K/V rows (and scales) by cp.async
//    through its own 2-stage ring. 1-byte values: 32-key sub-tiles, lane j
//    scores key j against the tile's vectors (q in shared memory), widening
//    the bytes in registers (widen4: integer and fp32 ops, no conversion
//    unit), the key's scale folded into its score and into its p. fp32:
//    16-key sub-tiles (32 keys of 4-byte rows would take 172 KB of rings at
//    D = 80, past one block an SM at D = 128), lanes j and j + 16 score key
//    j over alternate float4s of D and add by one shuffle. Then lane c
//    accumulates P.V for output values 4c..4c+3, four keys a step. The
//    tile size is a template parameter (4, 8 or 16 vectors), so a decode
//    row's loops hold no idle vectors. The warps' (m, l, acc) are merged in
//    shared memory in warp order, and the split writes (out, lse) for each
//    vector to scratch; a vector that sees no key of the split writes (0,
//    -1e30), which weighs nothing in the merge.
// 2. chunk_tile_kernel, grid chunk tiles * n_splits * Hkv: ragged blocks
//    find their (sequence, chunk tile) by a warp scan over q_lens, batched
//    ones by arithmetic, a sequence's last tile (the one with the most
//    keys) first. Each thread holds a 4-vector x kJ-key micro-tile of S =
//    Q K^T and a 4-vector x 16-value tile of O += P V; row max and sum, and
//    each key's p for P V, are shuffles among the 8 threads of a row.
//    1-byte values: 64-key tiles arrive by cp.async into one raw stage and
//    are widened and scaled once into fp32 shared memory (k = float(k_q) *
//    k_scale, as the JAX kernel dequantizes after its DMA); one raw stage
//    and no P tile in shared memory let three blocks share an SM. fp32:
//    32-key tiles go by cp.async straight into two stages of the same
//    fp32 tiles (63 KB at D = 80: three blocks an SM). Batched chunk tiles
//    split their keys like decode tiles when the plan says so (a grid short
//    of two waves of the card): each split writes (out, lse) to scratch.
// 3. merge_splits_kernel, grid tiles * Hkv: each tile's vectors merge the
//    splits their keys reach, in split order, as merge_partial_attention
//    does (src/repro/models/attention.py). A tile with no visible key has
//    its rows written as 0 here (B3's output is not zeroed beforehand).
//
// Only keys in [the window's first key, min(ctx, last row + 1, n_pages *
// page)) are ever copied, so slots outside a sequence's visible range
// (garbage after allocator reuse, poison) never reach a sum; slots of a
// stage no copy wrote are masked by selects, never multiplied by 0 (fp32
// bytes there may be NaN; widened 1-byte values are always finite). Every
// output is a fixed-order sum: no atomics, a second launch is bitwise
// equal.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace attn_body {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkVecs = 64;  // query vectors of a chunk tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;
// values narrower than fp32, widened after the copy: 1-byte or bf16
template <typename T>
constexpr bool kWide = !std::is_same<T, float>::value;
// 1-byte values, with f32 row scales (B2)
template <typename T>
constexpr bool kScaled = sizeof(T) == 1;
// keys of a warp's decode sub-tile
template <typename T>
constexpr int kSubKeys = kWide<T> ? 32 : 16;
// keys of a chunk tile's key tile: 8 threads of a row hold kChunkKeys / 8
template <typename T>
constexpr int kChunkKeys = kWide<T> ? 64 : 32;

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

// bf16 values widened to fp32 exactly: the low and the high value of a
// 4-byte pair, and 4 values from 8 bytes
__device__ __forceinline__ float bf_lo(uint32_t g) {
  return __uint_as_float(g << 16);
}

__device__ __forceinline__ float bf_hi(uint32_t g) {
  return __uint_as_float(g & 0xffff0000u);
}

__device__ __forceinline__ float4 widen4(uint2 g) {
  return make_float4(bf_lo(g.x), bf_hi(g.x), bf_lo(g.y), bf_hi(g.y));
}

// Values 4c..4c+3 of a K or V row in shared memory, as fp32.
template <typename T>
__device__ __forceinline__ float4 load4(const uint8_t* row, int c) {
  if constexpr (std::is_same<T, bf16>::value)
    return widen4(*reinterpret_cast<const uint2*>(row + 8 * c));
  else if constexpr (kScaled<T>)
    return widen4(*reinterpret_cast<const uint32_t*>(row + 4 * c), T{});
  else
    return reinterpret_cast<const float4*>(row)[c];
}

// The CH / sizeof(T) values of one CH-byte copy of a K row in shared
// memory (1-byte or bf16 values), as fp32.
template <typename T, int CH>
__device__ __forceinline__ void widen_chunk(const uint8_t* p, float* kf) {
  constexpr int kWords = CH / 4;
  uint32_t w[kWords];
  if constexpr (CH == 16) {
    const uint4 g = *reinterpret_cast<const uint4*>(p);
    w[0] = g.x;
    w[1] = g.y;
    w[2] = g.z;
    w[3] = g.w;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    if constexpr (kScaled<T>) {
      const float4 f = widen4(w[u], T{});
      kf[4 * u] = f.x;
      kf[4 * u + 1] = f.y;
      kf[4 * u + 2] = f.z;
      kf[4 * u + 3] = f.w;
    } else {
      kf[2 * u] = bf_lo(w[u]);
      kf[2 * u + 1] = bf_hi(w[u]);
    }
  }
}

// 4 consecutive values of q (fp32 or bf16) as fp32
__device__ __forceinline__ float4 q4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 q4(const bf16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}

// 4 consecutive output values, and one, in the output's type: bf16 rounded
// once to nearest even, as astype rounds
__device__ __forceinline__ void put4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void put4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ void put1(float* p, float v) { *p = v; }

__device__ __forceinline__ void put1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// Bytes between two K (or V) rows of `row_bytes` in shared memory: rounded
// to an odd number of copies, so lanes reading one row each hit distinct
// banks.
__host__ __device__ constexpr int row_stride(int row_bytes, int CH) {
  return ((row_bytes / CH) | 1) * CH;
}

// One stage of nk keys: nk K rows, nk V rows and, for 1-byte values, nk K
// and nk V scales.
template <typename T>
__host__ __device__ constexpr int stage_bytes(int nk, int rs) {
  return nk * (2 * rs + (kScaled<T> ? 8 : 0));
}

struct Raw {
  uint8_t* k;
  uint8_t* v;
  float* ks;
  float* vs;
};

template <typename T>
__device__ __forceinline__ Raw raw_at(uint8_t* base, int nk, int rs) {
  float* scales = reinterpret_cast<float*>(base + 2 * nk * rs);
  return {base, base + nk * rs, kScaled<T> ? scales : nullptr,
          kScaled<T> ? scales + nk : nullptr};
}

// What a block's sequence s and KV head hk see: pools, tables, geometry.
template <typename T>
struct Pools {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  const int* table;   // block_tables[s]
  const int* stable;  // scale_tables[s] (1-byte values)
  int page, Hkv, hk, D;
};

// Keys k0..k0+nk-1 (nk <= 32) into rows j0.. of r by one warp's cp.async:
// lane j reads key j's entries of both tables once, and every copy takes
// its row by shuffle, so no copy waits on a table read of its own. The
// caller commits.
template <typename T, int CH>
__device__ __forceinline__ void load_keys(const Raw& r, int rs, int k0,
                                          int nk, int j0, int lane,
                                          const Pools<T>& p) {
  unsigned long long row = 0;  // key lane's K/V row, in bytes
  if (lane < nk) {
    const int kv = k0 + lane, pg = kv / p.page, slot = kv % p.page;
    row = (((unsigned long long)p.table[pg] * p.page + slot) * p.Hkv +
           p.hk) * p.D * sizeof(T);
    if constexpr (kScaled<T>) {
      const size_t srow =
          ((size_t)p.stable[pg] * p.page + slot) * p.Hkv + p.hk;
      cp_async<4>(r.ks + j0 + lane, p.ks + srow);
      cp_async<4>(r.vs + j0 + lane, p.vs + srow);
    }
  }
  const int cpr = p.D * static_cast<int>(sizeof(T)) / CH, n = nk * cpr;
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

// The rows of one tile: packed rows [r0, r0 + n_rows) of sequence s (row
// r0 at position qpos0), which has ctx keys. n_rows <= 0: no tile.
struct Tile {
  int s, r0, n_rows, qpos0, ctx;
};

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

// The token-packed layout of B1 and B2 (see the top of this file).
struct Ragged {
  const int* ctx;       // context_lens (S,)
  const int* q_starts;  // (S,) first packed row
  const int* q_lens;    // (S,) rows; 0: a pad sequence
  const int* pos0;      // (S,) position of the first row
  int T_rows, S;

  // Sequence s as a decode tile; none when its rows x G pass nv.
  __device__ __forceinline__ Tile decode(int s, int G, int nv) const {
    const int q_len = q_lens[s];
    if (q_len <= 0 || q_len * G > nv) return {s, 0, 0, 0, 0};
    const int q_start = q_starts[s];
    const int n_rows = min(q_len, T_rows - q_start);
    if (n_rows <= 0) return {s, 0, 0, 0, 0};
    return {s, q_start, n_rows, pos0[s], ctx[s]};
  }

  // Chunk tile b (every thread calls: it synchronises).
  __device__ __forceinline__ Tile chunk(int b, int G, int dec_vecs,
                                        int rows) const {
    const int2 st = find_chunk_tile(q_lens, S, G, dec_vecs, rows, b);
    if (st.x < 0) return {-1, 0, 0, 0, 0};  // past the last chunk tile
    const int s = st.x, q_start = q_starts[s];
    const int r0 = q_start + st.y * rows;
    const int n_rows =
        min(min(q_start + q_lens[s], r0 + rows), T_rows) - r0;
    return {s, r0, n_rows, pos0[s] + (r0 - q_start), ctx[s]};
  }
};

// The batched layout of B3 (see the top of this file).
struct Batched {
  const int* ctx;       // context_lens (B,)
  const int* q_starts;  // (B,) position of row 0
  int Tq, B;

  __device__ __forceinline__ Tile decode(int b, int, int) const {
    return {b, b * Tq, Tq, q_starts[b], ctx[b]};
  }

  // Chunk tile `tile` of ceil(Tq / rows) a sequence, its last tile first.
  __device__ __forceinline__ Tile chunk(int tile, int, int, int rows) const {
    const int per_seq = (Tq + rows - 1) / rows;
    const int b = tile / per_seq, t = per_seq - 1 - tile % per_seq;
    if (b >= B) return {-1, 0, 0, 0, 0};
    return {b, b * Tq + t * rows, min(rows, Tq - t * rows),
            q_starts[b] + t * rows, ctx[b]};
  }
};

// Shared memory of decode_split_kernel for NV-vector tiles: q of the tile,
// each warp's p values, the warps' m and l, then each warp's 2-stage ring
// (the warps' accumulators reuse the rings once every key is consumed).
// Mirrored by kernels/paged_attention.py::body_smem.
template <typename T>
__host__ __device__ constexpr int decode_smem(int D, int CH, int NV) {
  return NV * D * 4 + kWarps * NV * kSubKeys<T> * 4 + 2 * kWarps * NV * 4 +
         kWarps * 2 *
             stage_bytes<T>(kSubKeys<T>,
                            row_stride(D * static_cast<int>(sizeof(T)), CH));
}

template <typename T, int CH, int NV, typename Lay, typename QT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const QT* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const float* __restrict__ ksp,
                    const float* __restrict__ vsp,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ scale_tables, const Lay lay,
                    float* __restrict__ part_o, float* __restrict__ part_lse,
                    int H, int Hkv, int D, int page, int n_pages, int window,
                    float scale, int n_splits, int split_keys) {
  constexpr int kSub = kSubKeys<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = H / Hkv;
  const int hk = blockIdx.x % Hkv;  // heads fastest: whole token rows
  const int s = blockIdx.x / Hkv / n_splits, sp = blockIdx.x / Hkv % n_splits;
  const Tile tile = lay.decode(s, G, NV);
  if (tile.n_rows <= 0) return;  // a chunk or pad sequence
  const KeyRange vis =
      visible(tile.qpos0, tile.n_rows, tile.ctx, n_pages * page, window);
  const int lo = max(vis.begin, sp * split_keys);
  const int hi = min(vis.end, (sp + 1) * split_keys);
  if (lo >= hi) return;  // the merge reads only splits with keys

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_vec = tile.n_rows * G, D4 = D / 4;
  const int rs = row_stride(D * static_cast<int>(sizeof(T)), CH);
  const int stage = stage_bytes<T>(kSub, rs);
  float* sQ = reinterpret_cast<float*>(smem);
  float* sP = sQ + NV * D;
  float* sM = sP + kWarps * NV * kSub;
  float* sL = sM + kWarps * NV;
  uint8_t* ring = reinterpret_cast<uint8_t*>(sL + kWarps * NV);
  uint8_t* mine = ring + warp * 2 * stage;
  const Pools<T> pools{kp, vp, ksp, vsp,
                       block_tables + (size_t)s * n_pages,
                       kScaled<T> ? scale_tables + (size_t)s * n_pages
                                 : nullptr,
                       page, Hkv, hk, D};

  // this warp's sub-tiles: keys from lo + kSub (warp + 4 i), i < n_mine
  const int n_sub = (hi - lo + kSub - 1) / kSub;
  const int n_mine = n_sub > warp ? (n_sub - warp + kWarps - 1) / kWarps : 0;
  const auto prefetch = [&](int i) {
    if (i < n_mine) {
      const int k0 = lo + kSub * (warp + kWarps * i);
      load_keys<T, CH>(raw_at<T>(mine + (i % 2) * stage, kSub, rs), rs, k0,
                       min(kSub, hi - k0), 0, lane, pools);
    }
    commit();
  };
  prefetch(0);
  prefetch(1);
  // q of the tile's vectors, zeros past n_vec (their scores are masked)
  for (int i = tid; i < NV * D4; i += kThreads) {
    const int v = i / D4, c = i % D4;
    reinterpret_cast<float4*>(sQ)[i] =
        v < n_vec ? q4(q + ((size_t)(tile.r0 + v / G) * H + hk * G + v % G) *
                               D + 4 * c)
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
  float* pw = sP + warp * NV * kSub;
  for (int i = 0; i < n_mine; ++i) {
    wait_pending<1>();
    __syncwarp();  // every lane's copies of stage i % 2 are in
    const Raw r = raw_at<T>(mine + (i % 2) * stage, kSub, rs);
    const int kb = lo + kSub * (warp + kWarps * i);
    const int nk = min(kSub, hi - kb);
    const int kv = kb + lane;
    // fp32: lanes 16.. hold the second half of keys 0..15's scores
    const bool kvalid = lane < kSub && lane < nk;

    // scores of key kv (this lane) against every vector; a lane past nk
    // reads bytes no copy wrote and is masked below
    float sc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) sc[v] = 0.f;
    if constexpr (kWide<T>) {
      constexpr int kVals = CH / static_cast<int>(sizeof(T));  // a copy's
      const uint8_t* krow = r.k + lane * rs;
      for (int c = 0; c < D; c += kVals) {
        float kf[kVals];
        widen_chunk<T, CH>(krow + c * sizeof(T), kf);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4* qv = reinterpret_cast<const float4*>(sQ + v * D + c);
#pragma unroll
          for (int u = 0; u < kVals / 4; ++u) {
            const float4 qq = qv[u];
            sc[v] = fmaf(qq.x, kf[4 * u], sc[v]);
            sc[v] = fmaf(qq.y, kf[4 * u + 1], sc[v]);
            sc[v] = fmaf(qq.z, kf[4 * u + 2], sc[v]);
            sc[v] = fmaf(qq.w, kf[4 * u + 3], sc[v]);
          }
        }
      }
    } else {
      // key lane % 16 over float4s lane / 16, + 2, ...: two half sums
      const float4* krow =
          reinterpret_cast<const float4*>(r.k + (lane % kSub) * rs);
      for (int c = lane / kSub; c < D4; c += 2) {
        const float4 kk = krow[c];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 qq = reinterpret_cast<const float4*>(sQ + v * D)[c];
          sc[v] = fmaf(qq.x, kk.x, sc[v]);
          sc[v] = fmaf(qq.y, kk.y, sc[v]);
          sc[v] = fmaf(qq.z, kk.z, sc[v]);
          sc[v] = fmaf(qq.w, kk.w, sc[v]);
        }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
        sc[v] += __shfl_xor_sync(kFull, sc[v], kSub);
    }
    float k_sc = scale, v_sc = 1.f;
    if constexpr (kScaled<T>) {
      k_sc = kvalid ? r.ks[lane] * scale : 0.f;
      v_sc = kvalid ? r.vs[lane] : 0.f;
    }

    // online softmax over the sub-tile's keys; p (times v_scale) to
    // shared memory. Widened values take each vector's max by its own chain
    // of shuffles; fp32 takes every vector's in the same five rounds,
    // independent chains the warp overlaps (faster on the card)
    const auto visible_key = [&](int v) {
      const int qp = tile.qpos0 + v / G;
      return v < n_vec && kvalid && kv <= qp &&
             (window <= 0 || qp - kv < window);
    };
    const auto update = [&](int v, bool ok, float sv, float mx) {
      const float m_new = fmaxf(m[v], mx);
      const float alpha = expf(m[v] - m_new);
      const float p = ok ? expf(sv - m_new) : 0.f;
      m[v] = m_new;
      l[v] = l[v] * alpha + p;
      acc[v][0] *= alpha;
      acc[v][1] *= alpha;
      acc[v][2] *= alpha;
      acc[v][3] *= alpha;
      if constexpr (kWide<T>)
        pw[v * kSub + lane] = p * v_sc;
      else if (lane < kSub)
        pw[v * kSub + lane] = p;
    };
    if constexpr (kWide<T>) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const bool ok = visible_key(v);
        const float sv = ok ? sc[v] * k_sc : kNegInf;
        update(v, ok, sv, warp_max(sv));
      }
    } else {
      bool ok[NV];
      float mx[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        ok[v] = visible_key(v);
        mx[v] = sc[v] = ok[v] ? sc[v] * k_sc : kNegInf;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int v = 0; v < NV; ++v)
          mx[v] = fmaxf(mx[v], __shfl_xor_sync(kFull, mx[v], off));
#pragma unroll
      for (int v = 0; v < NV; ++v) update(v, ok[v], sc[v], mx[v]);
    }
    __syncwarp();

    // acc += P . V, 4 keys at a time: values 4 * lane.. (p is 0 past nk;
    // there widened bytes are finite, and fp32 and bf16 rows are masked)
    if (lane < D4) {
      for (int j = 0; j < nk; j += 4) {
        float4 vf[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          vf[u] = load4<T>(r.v + (j + u) * rs, lane);
          if constexpr (!kScaled<T>)
            if (j + u >= nk) vf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              pw + v * kSub + j);
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

// Merges the splits of tile blockIdx.x / Hkv (a decode tile, or with
// `chunks` a batched chunk tile) of vecs vectors; scratch (tiles,
// n_splits, Hkv, vecs[, D]).
template <typename Lay, typename QT>
__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const float* __restrict__ part_o,
                    const float* __restrict__ part_lse, const Lay lay,
                    QT* __restrict__ out, int H, int Hkv, int D, int page,
                    int n_pages, int window, int n_splits, int split_keys,
                    int vecs, int dec_vecs, bool chunks) {
  const int G = H / Hkv;
  const int t = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const Tile tile =
      chunks ? lay.chunk(t, G, dec_vecs, vecs / G) : lay.decode(t, G, vecs);
  if (tile.n_rows <= 0) return;
  const KeyRange vis =
      visible(tile.qpos0, tile.n_rows, tile.ctx, n_pages * page, window);
  const int n = tile.n_rows * G * D;
  const auto at = [&](int v, int d) {
    return out + ((size_t)(tile.r0 + v / G) * H + hk * G + v % G) * D + d;
  };
  if (vis.begin >= vis.end) {  // no key: the rows are 0
    for (int i = threadIdx.x; i < n; i += kThreads) put1(at(i / D, i % D), 0.f);
    return;
  }
  const int sp0 = vis.begin / split_keys, sp1 = (vis.end - 1) / split_keys;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int v = i / D, d = i % D;
    const size_t base = ((size_t)t * n_splits * Hkv + hk) * vecs + v;
    const size_t step = (size_t)Hkv * vecs;  // one split further
    float M = kNegInf;
    for (int sp = sp0; sp <= sp1; ++sp)
      M = fmaxf(M, part_lse[base + sp * step]);
    float num = 0.f, den = 0.f;
    for (int sp = sp0; sp <= sp1; ++sp) {
      const float w = expf(part_lse[base + sp * step] - M);
      den += w;
      num = fmaf(part_o[(base + sp * step) * D + d], w, num);
    }
    put1(at(v, d), num / fmaxf(den, 1e-30f));
  }
}

// Shared memory of chunk_tile_kernel: q, then for 1-byte and bf16 values K
// and V widened (odd float4 stride) and one stage of raw keys (the next
// tile's copies land in it while this tile's fp32 copy is in use): 72.5 KB
// at D = 80 for 1-byte values (three blocks an SM), 85.5 KB for bf16 (two);
// for fp32 two stages of K and V tiles: 63 KB at D = 80 (three). Mirrored
// by body_smem.
template <typename T>
__host__ __device__ constexpr int chunk_smem(int D, int CH) {
  return kChunkVecs * D * 4 +
         (kWide<T> ? 2 * kChunkKeys<T> * ((D / 4) | 1) * 16 +
                         stage_bytes<T>(kChunkKeys<T>,
                                        row_stride(D * static_cast<int>(
                                                           sizeof(T)),
                                                   CH))
                   : 2 * 2 * kChunkKeys<T> * ((D / 4) | 1) * 16);
}

// kCC: float4 columns of O a thread holds (the 8 threads of a row cover
// 32 kCC values of D). 4 serves D <= 128; fp32 at D <= 96 takes 3, and the
// 16 registers that frees make its chunk tiles faster on the card.
template <typename T, int CH, typename Lay, int kCC, typename QT>
__global__ void __launch_bounds__(kThreads, 3)
chunk_tile_kernel(const QT* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const float* __restrict__ ksp,
                  const float* __restrict__ vsp,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ scale_tables, const Lay lay,
                  QT* __restrict__ out, float* __restrict__ part_o,
                  float* __restrict__ part_lse, int H, int Hkv, int D,
                  int page, int n_pages, int window, float scale,
                  int dec_vecs, int n_splits, int split_keys) {
  constexpr int kKeys = kChunkKeys<T>, kJ = kKeys / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / Hkv, rows_per_tile = kChunkVecs / G;
  const int hk = blockIdx.x % Hkv, rest = blockIdx.x / Hkv;
  const int sp = rest % n_splits, b = rest / n_splits;

  const Tile tile = lay.chunk(b, G, dec_vecs, rows_per_tile);
  if (tile.n_rows <= 0) return;  // past the last chunk tile (block-uniform)
  const int s = tile.s, r0 = tile.r0, qpos0 = tile.qpos0;
  KeyRange vis =
      visible(qpos0, tile.n_rows, tile.ctx, n_pages * page, window);
  if (n_splits > 1) {  // this split's keys; the merge reads splits with keys
    vis.begin = max(vis.begin, sp * split_keys);
    vis.end = min(vis.end, (sp + 1) * split_keys);
    if (vis.begin >= vis.end) return;
  }
  const int n_vec = tile.n_rows * G, D4 = D / 4, st4 = D4 | 1;
  const int rs =
      kWide<T> ? row_stride(D * static_cast<int>(sizeof(T)), CH) : st4 * 16;
  float4* sQ = reinterpret_cast<float4*>(smem);
  float4* sK = sQ + kChunkVecs * D4;  // widened values: the widened tile
  float4* sV = sK + kKeys * st4;
  uint8_t* raw = reinterpret_cast<uint8_t*>(sV + kKeys * st4);
  const Pools<T> pools{kp, vp, ksp, vsp,
                       block_tables + (size_t)s * n_pages,
                       kScaled<T> ? scale_tables + (size_t)s * n_pages
                                 : nullptr,
                       page, Hkv, hk, D};
  // fp32 key tile t lands in stage t % 2 (K then V)
  const auto stage_k = [&](int t) { return sK + (t % 2) * 2 * kKeys * st4; };
  const int n_kt = vis.end > vis.begin
                       ? (vis.end - vis.begin + kKeys - 1) / kKeys
                       : 0;
  constexpr int kPerWarp = kKeys / kWarps;
  const auto prefetch = [&](int t) {  // warp w copies its kPerWarp keys
    if (t < n_kt) {
      const int k0 = vis.begin + t * kKeys + kPerWarp * warp;
      const int nk = min(kPerWarp, vis.end - k0);
      if (nk > 0) {  // warp-uniform
        Raw r;
        if constexpr (kWide<T>) {
          r = raw_at<T>(raw, kKeys, rs);
        } else {
          uint8_t* k = reinterpret_cast<uint8_t*>(stage_k(t));
          r = {k, k + kKeys * rs, nullptr, nullptr};
        }
        load_keys<T, CH>(r, rs, k0, nk, kPerWarp * warp, lane, pools);
      }
    }
    commit();
  };
  prefetch(0);
  for (int i = tid; i < kChunkVecs * D4; i += kThreads) {
    const int v = i / D4, c = i % D4;
    sQ[i] = v < n_vec ? q4(q + ((size_t)(r0 + v / G) * H + hk * G + v % G) *
                                   D + 4 * c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // thread (tv, tk): vectors tv + 16 i (i < 4); keys tk + 8 j (j < kJ) of
  // a key tile in S; output values 4 (tk + 8 cc).. (cc < kCC) in O
  const int tv = tid / 8, tk = tid % 8;
  float m[4], l[4];
  int qp[4];
  bool vok[4];
  float4 acc[4][kCC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = tv + 16 * i;
    m[i] = kNegInf;
    l[i] = 0.f;  // this thread's share: summed over the row's 8 at the end
    vok[i] = v < n_vec;
    qp[i] = qpos0 + v / G;
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) acc[i][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < n_kt; ++t) {
    wait_pending<0>();
    __syncthreads();  // key tile t is in; the last tile's P.V is done
    const int kb = vis.begin + t * kKeys;
    const int nk = min(kKeys, vis.end - kb);
    const float4* tK;
    const float4* tV;
    if constexpr (kWide<T>) {
      const Raw r = raw_at<T>(raw, kKeys, rs);
      for (int i = tid; i < kKeys * D4; i += kThreads) {
        const int j = i / D4, c = i % D4;
        float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
        if (j < nk) {
          kf = load4<T>(r.k + j * rs, c);
          vf = load4<T>(r.v + j * rs, c);
          if constexpr (kScaled<T>) {
            const float a = r.ks[j], bsc = r.vs[j];
            kf = make_float4(kf.x * a, kf.y * a, kf.z * a, kf.w * a);
            vf = make_float4(vf.x * bsc, vf.y * bsc, vf.z * bsc,
                             vf.w * bsc);
          }
        }
        sK[j * st4 + c] = kf;
        sV[j * st4 + c] = vf;
      }
      __syncthreads();  // the fp32 tile is ready; the raw stage is consumed
      tK = sK;
      tV = sV;
    } else {
      tK = stage_k(t);  // keys past nk hold stale bytes: masked below
      tV = tK + kKeys * st4;
      if (nk < kKeys) {  // V rows no copy wrote: 0 (their p is 0)
        float4* zV = stage_k(t) + kKeys * st4;
        for (int i = tid; i < (kKeys - nk) * D4; i += kThreads)
          zV[(nk + i / D4) * st4 + i % D4] = make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();
      }
    }
    prefetch(t + 1);

    // S = Q K^T for this thread's 4 x kJ micro-tile; fp32 takes two
    // float4s of D a trip, so the next loads issue under this one's FMAs
    // (faster on the card; slower for widened values, which keep one)
    float sc[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) sc[i][j] = 0.f;
    const auto score = [&](int c) {
      float4 qq[4], kk[kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qq[i] = sQ[(tv + 16 * i) * D4 + c];
#pragma unroll
      for (int j = 0; j < kJ; ++j) kk[j] = tK[(tk + 8 * j) * st4 + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          sc[i][j] = fmaf(qq[i].x, kk[j].x, sc[i][j]);
          sc[i][j] = fmaf(qq[i].y, kk[j].y, sc[i][j]);
          sc[i][j] = fmaf(qq[i].z, kk[j].z, sc[i][j]);
          sc[i][j] = fmaf(qq[i].w, kk[j].w, sc[i][j]);
        }
    };
    if constexpr (kWide<T>) {
      for (int c = 0; c < D4; ++c) score(c);
    } else {
#pragma unroll 2
      for (int c = 0; c < D4; ++c) score(c);
    }

    // online softmax: the row's max over its 8 threads (lanes xor 1, 2, 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
      bool ok[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
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
      for (int j = 0; j < kJ; ++j) {
        sc[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;  // p, key tk + 8j
        sum += sc[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int cc = 0; cc < kCC; ++cc) {
        acc[i][cc].x *= alpha;
        acc[i][cc].y *= alpha;
        acc[i][cc].z *= alpha;
        acc[i][cc].w *= alpha;
      }
    }
    // O += P V over the tile's keys in order: key 8 jj + kk's p comes from
    // lane kk of this row's 8 (nk is block-uniform: every lane shuffles).
    // widened values stop at nk; fp32 runs the whole tile without a branch
    // (p is 0 past nk and those V rows were zeroed)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int j = 8 * jj + kk;
        if constexpr (kWide<T>)
          if (j >= nk) break;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = __shfl_sync(kFull, sc[i][jj], (lane & ~7) | kk);
#pragma unroll
        for (int cc = 0; cc < kCC; ++cc) {
          const int c = tk + 8 * cc;
          if (c < D4) {
            const float4 vv = tV[j * st4 + c];
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
    float* prow = nullptr;  // this split's scratch row
    QT* orow = out + ((size_t)(r0 + v / G) * H + hk * G + v % G) * D;
    if (n_splits > 1) {
      const size_t idx =
          (((size_t)b * n_splits + sp) * Hkv + hk) * kChunkVecs + v;
      prow = part_o + idx * D;
      if (tk == 0) part_lse[idx] = li > 0.f ? m[i] + logf(li) : kNegInf;
    }
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      const int c = tk + 8 * cc;
      if (c < D4) {
        const float4 o = make_float4(acc[i][cc].x * inv, acc[i][cc].y * inv,
                                     acc[i][cc].z * inv, acc[i][cc].w * inv);
        if constexpr (std::is_same<QT, float>::value)  // one store path
          put4(n_splits > 1 ? prow + 4 * c : orow + 4 * c, o);
        else if (n_splits > 1)
          put4(prow + 4 * c, o);
        else
          put4(orow + 4 * c, o);
      }
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

// One call's launches on `stream` (see the top of this file), from the
// wrapper's plan: dec_tiles decode tiles of dec_vecs vectors (4, 8 or 16),
// their keys in n_splits splits of split_keys, then their merge; chunk_tiles
// chunk tiles (upper bound), their keys in chunk_splits splits of
// chunk_split_keys, merged when there are more than one. A launch of no
// block is skipped. part_o and part_lse are the caller's scratch, (tiles,
// splits, Hkv, vecs[, D]) for whichever kind splits (a call of the ragged
// layout splits only decode tiles, one of the batched layout has one kind
// of tile). dec_smem and chunk_smem are the plan's shared memory
// (body_smem); a plan that disagrees with this file is refused. Returns the
// first launch error, or 0.
template <typename T, int CH, typename Lay, typename QT>
int launch(const QT* q, const T* kp, const T* vp, const float* ks,
           const float* vs, const int* bt, const int* st, const Lay& lay,
           QT* out, float* part_o, float* part_lse, int H, int Hkv, int D,
           int page, int n_pages, int window, float scale, int dec_tiles,
           int dec_vecs, int n_splits, int split_keys, int chunk_tiles,
           int chunk_splits, int chunk_split_keys, int dec_smem,
           int chk_smem, cudaStream_t stream) {
  const int dec = decode_smem<T>(D, CH, dec_vecs);
  const int chk = chunk_smem<T>(D, CH);
  if ((dec_tiles > 0 && dec_smem != dec) ||
      (chunk_tiles > 0 && chk_smem != chk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dec_tiles > 0) {
    const auto decode = [&](auto kernel, cudaError_t allowed) {
      if (allowed != cudaSuccess) return allowed;
      kernel<<<dec_tiles * n_splits * Hkv, kThreads, dec, stream>>>(
          q, kp, vp, ks, vs, bt, st, lay, part_o, part_lse, H, Hkv, D, page,
          n_pages, window, scale, n_splits, split_keys);
      return cudaGetLastError();
    };
    err = cudaErrorInvalidValue;  // dec_vecs not 4, 8 or 16
    if (dec_vecs == 4)
      err = decode(decode_split_kernel<T, CH, 4, Lay, QT>,
                   allow_smem<decode_split_kernel<T, CH, 4, Lay, QT>>(dec));
    if (dec_vecs == 8)
      err = decode(decode_split_kernel<T, CH, 8, Lay, QT>,
                   allow_smem<decode_split_kernel<T, CH, 8, Lay, QT>>(dec));
    if (dec_vecs == 16)
      err = decode(decode_split_kernel<T, CH, 16, Lay, QT>,
                   allow_smem<decode_split_kernel<T, CH, 16, Lay, QT>>(dec));
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_splits_kernel<Lay, QT><<<dec_tiles * Hkv, kThreads, 0, stream>>>(
        part_o, part_lse, lay, out, H, Hkv, D, page, n_pages, window,
        n_splits, split_keys, dec_vecs, dec_vecs, false);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (chunk_tiles > 0) {
    const auto chunk = [&](auto kernel, cudaError_t allowed) {
      if (allowed != cudaSuccess) return allowed;
      kernel<<<chunk_tiles * chunk_splits * Hkv, kThreads, chk, stream>>>(
          q, kp, vp, ks, vs, bt, st, lay, out, part_o, part_lse, H, Hkv, D,
          page, n_pages, window, scale, dec_vecs, chunk_splits,
          chunk_split_keys);
      return cudaGetLastError();
    };
    err = cudaErrorInvalidValue;
    if constexpr (!kWide<T>) {  // widened values: only 4 columns
      if (D <= 96)
        err = chunk(chunk_tile_kernel<T, CH, Lay, 3, QT>,
                    allow_smem<chunk_tile_kernel<T, CH, Lay, 3, QT>>(chk));
    }
    if (kWide<T> || D > 96)
      err = chunk(chunk_tile_kernel<T, CH, Lay, 4, QT>,
                  allow_smem<chunk_tile_kernel<T, CH, Lay, 4, QT>>(chk));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (chunk_splits > 1) {
      merge_splits_kernel<Lay, QT>
          <<<chunk_tiles * Hkv, kThreads, 0, stream>>>(
          part_o, part_lse, lay, out, H, Hkv, D, page, n_pages, window,
          chunk_splits, chunk_split_keys, kChunkVecs, dec_vecs, true);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace attn_body
