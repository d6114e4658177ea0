// Batched paged attention, fp32 and bf16, for Hopper (sm_90a): kernel B3.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention
//   (grid body _kernel, grid (B, Hkv, n_pages)).
// Same contract as repro_torch/kernels/ref.py::paged_attention_ref:
// q (B, Tq, H, D); row (b, t) sits at the GLOBAL position
// q_pos = q_starts[b] + t (not an offset into a packed stream, as in the
// ragged kernel) and attends to every kv_pos with kv_pos < context_lens[b],
// kv_pos <= q_pos and, with a window, q_pos - kv_pos < window, reading K/V
// through block_table[b, kv_pos / page]. Every row (b, t) is written; a
// row with no visible key gives exactly 0 (the output is not zeroed
// beforehand: the merge, or a chunk tile with no split, writes those rows).
//
// Where it runs: the sequential-mode chunk (B = 1, Tq = chunk) and decode
// (Tq = 1) steps, committed multi-step decode, the speculative draft
// steps (Tq = 1) and verify pass (Tq = gamma + 1), and the fused step's
// non-ragged backend.
//
// What bounds it on the H100: at Tq <= gamma + 1 the bytes of visible K/V
// read from device memory (each key serves only the Tq x G query vectors of
// its KV head); in long prefill chunks the fp32 dot products (CUDA cores,
// no TF32).
//
// Design: the body B1 and B2 share (attention_body.cuh), instantiated for
// fp32 pools in the batched layout. The Pallas kernel walks every page of
// the table in a sequential grid dimension, carrying the online softmax in
// scratch; on the GPU blocks run in parallel and in no order. Every
// sequence has Tq rows, so a call is one kind of tile. Tq x G <= 16: decode
// tiles of Tq x G vectors rounded up to 4, 8 or 16, their keys split into
// fixed splits of a few hundred (one block per sequence, split and KV
// head, 16-key sub-tiles a warp through cp.async rings), merged by a second
// launch. Otherwise: chunk tiles of 64 vectors (64 / G rows), 32-key K/V
// tiles by cp.async into two shared-memory stages, register micro-tiles
// for S and O; when those tiles fall short of two waves of the card the
// plan splits their keys too and the same merge launch combines them. The
// blocks read only the keys a tile can see, from the window's first key to
// min(context_len, last q_pos + 1): table columns past the context point
// at trash page 0 and slots outside the range hold garbage, and neither is
// ever loaded. The plan (kernels/paged_attention.py::batched_plan) comes
// from host-known sizes only, never from context_lens.
//
// bf16 (paged_attention_bf16): q, the pools and out in bf16, fp32 math,
// the pools on the body's widening route (as B1's bf16 launcher), D % 8 ==
// 0.
#include "attention_body.cuh"

namespace {

template <typename T>
int launch_batched(const T* q, const T* k_pages, const T* v_pages,
                   const int* block_table, const int* context_lens,
                   const int* q_starts, T* out, float* part_o,
                   float* part_lse, int B, int Tq, int H, int Hkv, int D,
                   int page_size, int n_pages, int window, float scale,
                   int vecs, int n_splits, int split_keys, int smem,
                   void* stream) {
  using attn_body::kChunkVecs;
  const attn_body::Batched lay{context_lens, q_starts, Tq, B};
  const bool chunks = vecs == kChunkVecs;
  const int rows = kChunkVecs / (H / Hkv);
  const int chunk_tiles = chunks ? B * ((Tq + rows - 1) / rows) : 0;
  return attn_body::launch<T, 16>(
      q, k_pages, v_pages, nullptr, nullptr, block_table, nullptr, lay, out,
      part_o, part_lse, H, Hkv, D, page_size, n_pages, window, scale,
      chunks ? 0 : B, chunks ? 4 : vecs, n_splits, split_keys, chunk_tiles,
      n_splits, split_keys, smem, smem, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C launcher (bound with ctypes). Shapes: q/out (B, Tq, H, D); pools
// (P, page_size, Hkv, D); block_table (B, n_pages); context_lens and
// q_starts (B,) int32; f32 scratch part_o (tiles, n_splits, Hkv, vecs, D)
// and part_lse (tiles, n_splits, Hkv, vecs) when the plan splits. window
// <= 0 means no window. From the wrapper's plan: vecs (4, 8 or 16: decode
// tiles; 64: chunk tiles of 64 / G rows), the splits and the kernel's
// shared memory. The wrapper checks that D % 4 == 0, D <= 128, H % Hkv ==
// 0 and 16 % (H / Hkv) == 0, B <= 65535, that q, the pools and out are
// 16-byte aligned, and that the grids fit. Returns the first cudaError_t
// of the launches, or 0.
extern "C" int paged_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* block_table, const int* context_lens, const int* q_starts,
    float* out, float* part_o, float* part_lse, int B, int Tq, int H,
    int Hkv, int D, int page_size, int n_pages, int window, float scale,
    int vecs, int n_splits, int split_keys, int smem, void* stream) {
  return launch_batched(q, k_pages, v_pages, block_table, context_lens,
                        q_starts, out, part_o, part_lse, B, Tq, H, Hkv, D,
                        page_size, n_pages, window, scale, vecs, n_splits,
                        split_keys, smem, stream);
}

// The same over bf16 q, pools and out (D % 8 == 0; the scratch stays f32).
extern "C" int paged_attention_bf16(
    const attn_body::bf16* q, const attn_body::bf16* k_pages,
    const attn_body::bf16* v_pages, const int* block_table,
    const int* context_lens, const int* q_starts, attn_body::bf16* out,
    float* part_o, float* part_lse, int B, int Tq, int H, int Hkv, int D,
    int page_size, int n_pages, int window, float scale, int vecs,
    int n_splits, int split_keys, int smem, void* stream) {
  return launch_batched(q, k_pages, v_pages, block_table, context_lens,
                        q_starts, out, part_o, part_lse, B, Tq, H, Hkv, D,
                        page_size, n_pages, window, scale, vecs, n_splits,
                        split_keys, smem, stream);
}
