// Token-packed ragged paged attention over quantized K/V (int8 or
// fp8-e4m3 values, f32 per-(token, KV head) scales), for Hopper (sm_90a):
// kernel B2.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention_ragged_quant
//   (grid body _ragged_impl with quant=True, via _ragged_quant_kernel).
// Same contract as repro_torch/kernels/ref.py::
// paged_attention_ragged_quant_ref: B1's contract, with value pools
// (P, page, Hkv, D) of int8 or fp8-e4m3, scale pools (Ps, page, Hkv) f32
// and scale_tables (S, n_pages) parallel to block_tables
// (BlockAllocator.scale_table). Each K/V element is dequantized after the
// load, float(k_q) * k_scale[row] (DESIGN.md §14), so the oracle and the
// kernel read the same values and differ only in summation order (decode
// tiles fold each row's scale into its score and its p instead: a
// rounding-level difference).
//
// What bounds it on the H100. Decode: the K/V bytes, 1 per element plus 4
// per row scale, a quarter of B1's, and each byte feeds only the G (4 in
// h2o-danube) query heads of its KV head, so one (sequence, KV head) has
// too little work to fill an SM and its keys must be spread over blocks.
// Prefill chunks: the fp32 FMAs of Q K^T and P V on the CUDA cores.
//
// Design (attention_body.cuh, the body B1 and B3 share, instantiated here
// for 1-byte values in the ragged layout). The TPU kernel carries its
// online-softmax state across a sequential (sequence, page block) grid.
// Here decode tiles (rows x G <= max(4, G) vectors: a decode row) are
// split-KV: one block per (sequence, fixed split of a few hundred keys, KV
// head), warps on 32-key sub-tiles streamed by cp.async through 2-stage
// rings and widened in registers, each split's (out, lse) to scratch, and
// a second launch merging the splits in order. Chunk tiles (64 vectors)
// widen 64-key tiles once into fp32 shared memory and compute S and P V as
// register micro-tiles, 4 vectors x 8 keys and 4 vectors x 16 values per
// thread. The split size, split count and every grid come from host-known
// sizes (the wrapper's plan, kernels/paged_attention.py::quant_plan),
// never from context_lens.
#include <type_traits>

#include "attention_body.cuh"

namespace {

template <typename T>
int launch(const float* q, const T* kp, const T* vp, const float* ks,
           const float* vs, const int* bt, const int* st, const int* ctx,
           const int* qs, const int* ql, const int* p0, float* out,
           float* part_o, float* part_lse, int T_rows, int H, int Hkv, int D,
           int page, int S, int n_pages, int window, float scale,
           int n_splits, int split_keys, int dec_vecs, int chunk_tiles,
           int dec_smem, int chunk_smem, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const attn_body::Ragged lay{ctx, qs, ql, p0, T_rows, S};
  const auto go = [&](auto ch) {
    return attn_body::launch<T, decltype(ch)::value>(
        q, kp, vp, ks, vs, bt, st, lay, out, part_o, part_lse, H, Hkv, D,
        page, n_pages, window, scale, S, dec_vecs, n_splits, split_keys,
        chunk_tiles, 1, n_pages * page, dec_smem, chunk_smem,
        static_cast<cudaStream_t>(stream));
  };
  if (D % 16 == 0 && aligned(kp) && aligned(vp))
    return go(std::integral_constant<int, 16>{});
  return go(std::integral_constant<int, 4>{});
}

}  // namespace

// Plain C launchers (bound with ctypes), one per value type. Shapes: q/out
// (T, H, D) f32; k_pages/v_pages (P, page_size, Hkv, D) int8 or fp8-e4m3;
// k_scales/v_scales (Ps, page_size, Hkv) f32; block_tables and
// scale_tables (S, n_pages); the four (S,) int32 arrays; f32 scratch
// part_o (S, n_splits, Hkv, dec_vecs, D) and part_lse (S, n_splits, Hkv,
// dec_vecs). window <= 0 means no window. The split size and count,
// dec_vecs (4, 8 or 16), chunk_tiles and the two kernels' shared memory
// come from the wrapper's plan, which also checks D % 4 == 0, D <= 128,
// H % Hkv == 0 and 16 % (H / Hkv) == 0, that q and out are 16-byte and the
// value pools 4-byte aligned, and that the grids fit. Return the first
// cudaError_t of the three launches, or 0.
extern "C" int paged_attention_ragged_quant_i8(
    const float* q, const int8_t* k_pages, const int8_t* v_pages,
    const float* k_scales, const float* v_scales, const int* block_tables,
    const int* scale_tables, const int* context_lens, const int* q_starts,
    const int* q_lens, const int* pos0, float* out, float* part_o,
    float* part_lse, int T, int H, int Hkv, int D, int page_size, int S,
    int n_pages, int window, float scale, int n_splits, int split_keys,
    int dec_vecs, int chunk_tiles, int dec_smem, int chunk_smem,
    void* stream) {
  return launch<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                        block_tables, scale_tables, context_lens, q_starts,
                        q_lens, pos0, out, part_o, part_lse, T, H, Hkv, D,
                        page_size, S, n_pages, window, scale, n_splits,
                        split_keys, dec_vecs, chunk_tiles, dec_smem,
                        chunk_smem, stream);
}

extern "C" int paged_attention_ragged_quant_f8(
    const float* q, const __nv_fp8_e4m3* k_pages,
    const __nv_fp8_e4m3* v_pages, const float* k_scales,
    const float* v_scales, const int* block_tables, const int* scale_tables,
    const int* context_lens, const int* q_starts, const int* q_lens,
    const int* pos0, float* out, float* part_o, float* part_lse, int T,
    int H, int Hkv, int D, int page_size, int S, int n_pages, int window,
    float scale, int n_splits, int split_keys, int dec_vecs,
    int chunk_tiles, int dec_smem, int chunk_smem, void* stream) {
  return launch<__nv_fp8_e4m3>(q, k_pages, v_pages, k_scales, v_scales,
                               block_tables, scale_tables, context_lens,
                               q_starts, q_lens, pos0, out, part_o, part_lse,
                               T, H, Hkv, D, page_size, S, n_pages, window,
                               scale, n_splits, split_keys, dec_vecs,
                               chunk_tiles, dec_smem, chunk_smem, stream);
}
