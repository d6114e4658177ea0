// The token-packed ragged paged-attention kernel, templated over the K/V
// pool's element type: float (paged_attention_ragged.cu, kernel B1) and
// int8_t / __nv_fp8_e4m3 (paged_attention_ragged_quant.cu, kernel B2).
//
// Contract (repro_torch/kernels/ref.py::paged_attention_ragged_ref and
// ::paged_attention_ragged_quant_ref): sequence s owns packed rows
// [q_starts[s], q_starts[s] + q_lens[s]); row t sits at
// q_pos = pos0[s] + t - q_starts[s] and attends to every kv_pos with
// kv_pos < context_lens[s], kv_pos <= q_pos and, with a window,
// q_pos - kv_pos < window, reading K/V through block_tables[s, kv_pos /
// page] (and, quantized, the row scales through scale_tables[s, kv_pos /
// page]). A row with no visible key gives 0. Rows owned by no sequence are
// left untouched: the wrapper hands in a zeroed output.
//
// Each block owns one (sequence, KV head, tile of that sequence's rows)
// and loops over the sequence's keys itself, in the shared tile body
// (attention_tile.cuh). Blocks find their (sequence, tile) by a warp scan
// over q_lens, so the launch needs no host-side knowledge of the ragged
// layout: the grid is ceil(T / rows per tile) + S blocks per KV head, an
// upper bound on the tiles of any layout of T rows over S sequences.
#pragma once

#include "attention_tile.cuh"

namespace attn_tile {

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ scale_tables,
    const int* __restrict__ context_lens, const int* __restrict__ q_starts,
    const int* __restrict__ q_lens, const int* __restrict__ pos0,
    float* __restrict__ out, int T_rows, int H, int Hkv, int D,
    int page_size, int S, int n_pages, int window, float scale) {
  __shared__ int sSeq, sTile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hk = blockIdx.y;
  const int rows_per_tile = kVecs / (H / Hkv);
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
  if (s < 0) return;  // past the last tile of the step (block-uniform)

  const int q_start = q_starts[s];
  const int r0 = q_start + sTile * rows_per_tile;
  const int r_end = min(min(q_start + q_lens[s], r0 + rows_per_tile), T_rows);
  attend_tile<T>(
      q + (size_t)r0 * H * D, out + (size_t)r0 * H * D, max(r_end - r0, 0),
      pos0[s] + (r0 - q_start), context_lens[s],
      block_tables + (size_t)s * n_pages, n_pages, k_pages, v_pages,
      scale_tables == nullptr ? nullptr : scale_tables + (size_t)s * n_pages,
      k_scales, v_scales, H, Hkv, D, page_size, hk, window, scale);
}

// The launch of the kernel above: every sequence's tiles, sum ceil(q_len /
// rows) <= T / rows + S, times Hkv. Returns cudaGetLastError() right after.
template <typename T>
int launch_ragged(const float* q, const T* k_pages, const T* v_pages,
                  const float* k_scales, const float* v_scales,
                  const int* block_tables, const int* scale_tables,
                  const int* context_lens, const int* q_starts,
                  const int* q_lens, const int* pos0, float* out, int T_rows,
                  int H, int Hkv, int D, int page_size, int S, int n_pages,
                  int window, float scale, void* stream) {
  const int rows_per_tile = kVecs / (H / Hkv);
  const dim3 grid((T_rows + rows_per_tile - 1) / rows_per_tile + S, Hkv);
  ragged_paged_attention_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          q, k_pages, v_pages, k_scales, v_scales, block_tables,
          scale_tables, context_lens, q_starts, q_lens, pos0, out, T_rows, H,
          Hkv, D, page_size, S, n_pages, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_tile
