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
// sequence's rows) and loops over the sequence's keys itself, in the tile
// body shared with the batched kernel (attention_tile.cuh: 16 query
// vectors = rows x the G heads of the KV head, keys from the window's
// first key to min(context_len, last q_pos + 1), online softmax in
// registers). Blocks find their (sequence, tile) by a warp scan over
// q_lens, so the launch needs no host-side knowledge of the ragged layout.
// wgmma, TMA and split-K over long contexts are later work.
#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, const int* __restrict__ q_starts,
    const int* __restrict__ q_lens, const int* __restrict__ pos0,
    float* __restrict__ out, int T, int H, int Hkv, int D, int page_size,
    int S, int n_pages, int window, float scale) {
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
  const int r_end = min(min(q_start + q_lens[s], r0 + rows_per_tile), T);
  attend_tile(q + (size_t)r0 * H * D, out + (size_t)r0 * H * D,
              max(r_end - r0, 0), pos0[s] + (r0 - q_start), context_lens[s],
              block_tables + (size_t)s * n_pages, n_pages, k_pages, v_pages,
              H, Hkv, D, page_size, hk, window, scale);
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
