// Token-packed ragged paged attention, fp32, for Hopper (sm_90a): kernel B1.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention_ragged
//   (grid body _ragged_impl via _ragged_kernel).
// Same contract as repro_torch/kernels/ref.py::paged_attention_ragged_ref;
// the kernel is ragged_kernel.cuh's, instantiated for fp32 pools.
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
#include "ragged_kernel.cuh"

// Plain C launcher (bound with ctypes). Shapes: q/out (T, H, D); pools
// (P, page_size, Hkv, D); block_tables (S, n_pages); the four (S,) int32
// arrays. window <= 0 means no window. The wrapper checks that D % 4 == 0,
// D <= 128, H % Hkv == 0 and 16 % (H / Hkv) == 0, and that q, the pools
// and out are 16-byte aligned. Returns the cudaError_t of
// cudaGetLastError() right after the launch.
extern "C" int paged_attention_ragged_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* block_tables, const int* context_lens, const int* q_starts,
    const int* q_lens, const int* pos0, float* out, int T, int H, int Hkv,
    int D, int page_size, int S, int n_pages, int window, float scale,
    void* stream) {
  return attn_tile::launch_ragged<float>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, nullptr,
      context_lens, q_starts, q_lens, pos0, out, T, H, Hkv, D, page_size, S,
      n_pages, window, scale, stream);
}
