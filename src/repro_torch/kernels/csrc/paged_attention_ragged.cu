// Token-packed ragged paged attention, fp32 and bf16, for Hopper (sm_90a):
// kernel B1.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention_ragged
//   (grid body _ragged_impl via _ragged_kernel).
// Same contract as repro_torch/kernels/ref.py::paged_attention_ragged_ref.
//
// What bounds it on the H100: in decode the bytes of K/V read from device
// memory (each key is used by only the G query heads of its KV head, 4 in
// h2o-danube), so one (sequence, KV head) has too little work to fill an
// SM and its keys must be spread over blocks, never reading past a
// context. In long prefill chunks the fp32 dot products (CUDA cores; no
// TF32) dominate.
//
// Design: the body B2 and B3 share (attention_body.cuh), instantiated for
// fp32 pools in the ragged layout. The TPU kernel carries its
// online-softmax state across a sequential (seq, page_block) grid; on the
// GPU blocks run in parallel and in no order. Decode rows are split-KV
// tiles: one block per (sequence, fixed split of a few hundred keys, KV
// head), warps on 16-key sub-tiles streamed by 16-byte cp.async through
// 2-stage rings, each split's (out, lse) to scratch and a second launch
// merging the splits in order. Prefill chunks are 64-vector tiles whose
// 32-key K/V tiles arrive by cp.async into two shared-memory stages while
// each thread computes a 4 x 4 micro-tile of S and a 4 x 16 tile of O. The
// plan (kernels/paged_attention.py::quant_plan, shared with B2) comes from
// host-known sizes only. wgmma and TF32 are later work.
//
// bf16 (paged_attention_ragged_bf16): q, the pools and out in bf16, the
// Pallas kernel's contract (fp32 math, out in q's dtype). The pools take
// the widening route of B2's 1-byte pools (32-key decode sub-tiles,
// 64-key chunk tiles widened once into fp32 shared memory) with no scales,
// at half the bytes of an fp32 key; rows move 16 bytes at a time, so D %
// 8 == 0 (the wrapper checks).
#include "attention_body.cuh"

// Plain C launcher (bound with ctypes). Shapes: q/out (T, H, D); pools
// (P, page_size, Hkv, D); block_tables (S, n_pages); the four (S,) int32
// arrays; f32 scratch part_o (S, n_splits, Hkv, dec_vecs, D) and part_lse
// (S, n_splits, Hkv, dec_vecs). window <= 0 means no window. The split
// size and count, dec_vecs (4, 8 or 16), chunk_tiles and the two kernels'
// shared memory come from the wrapper's plan, which also checks that
// D % 4 == 0, D <= 128, H % Hkv == 0 and 16 % (H / Hkv) == 0, that q, the
// pools and out are 16-byte aligned, and that the grids fit. Returns the
// first cudaError_t of the three launches, or 0.
extern "C" int paged_attention_ragged_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* block_tables, const int* context_lens, const int* q_starts,
    const int* q_lens, const int* pos0, float* out, float* part_o,
    float* part_lse, int T, int H, int Hkv, int D, int page_size, int S,
    int n_pages, int window, float scale, int n_splits, int split_keys,
    int dec_vecs, int chunk_tiles, int dec_smem, int chunk_smem,
    void* stream) {
  const attn_body::Ragged lay{context_lens, q_starts, q_lens, pos0, T, S};
  return attn_body::launch<float, 16>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, nullptr, lay, out,
      part_o, part_lse, H, Hkv, D, page_size, n_pages, window, scale, S,
      dec_vecs, n_splits, split_keys, chunk_tiles, 1, n_pages * page_size,
      dec_smem, chunk_smem, static_cast<cudaStream_t>(stream));
}

// The same over bf16 q, pools and out (D % 8 == 0; the scratch stays f32).
extern "C" int paged_attention_ragged_bf16(
    const attn_body::bf16* q, const attn_body::bf16* k_pages,
    const attn_body::bf16* v_pages, const int* block_tables,
    const int* context_lens, const int* q_starts, const int* q_lens,
    const int* pos0, attn_body::bf16* out, float* part_o, float* part_lse,
    int T, int H, int Hkv, int D, int page_size, int S, int n_pages,
    int window, float scale, int n_splits, int split_keys, int dec_vecs,
    int chunk_tiles, int dec_smem, int chunk_smem, void* stream) {
  const attn_body::Ragged lay{context_lens, q_starts, q_lens, pos0, T, S};
  return attn_body::launch<attn_body::bf16, 16>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, nullptr, lay, out,
      part_o, part_lse, H, Hkv, D, page_size, n_pages, window, scale, S,
      dec_vecs, n_splits, split_keys, chunk_tiles, 1, n_pages * page_size,
      dec_smem, chunk_smem, static_cast<cudaStream_t>(stream));
}
