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
// load and before the dot products, k = float(k_q) * k_scale[row], as the
// JAX kernel does after its DMA (DESIGN.md §14), so the oracle and the
// kernel read the same fp32 values and differ only in summation order.
//
// What bounds it on the H100: the same as B1 with a quarter of the K/V
// bytes (1 byte per element plus 4 per row scale instead of 4 per
// element). In decode the bound therefore drops to about a quarter of
// B1's; the tile body is latency-bound at decode shapes, so the kernel
// sits further from its bound than B1 (making it fast is later work).
//
// Design: ragged_kernel.cuh's kernel instantiated for int8_t and
// __nv_fp8_e4m3 pools (one extern "C" launcher per value type). The tile
// body (attention_tile.cuh) reads a quantized row as 4-byte groups of 4
// values (the wrapper checks 4-byte alignment of the pools), reads the
// scales of each tile's keys once into shared memory, and widens and
// scales every group into the fp32 tile in shared memory: everything after
// the load is the fp32 kernel's arithmetic.
#include "ragged_kernel.cuh"

// Plain C launchers (bound with ctypes), one per value type. Shapes: q/out
// (T, H, D) f32; k_pages/v_pages (P, page_size, Hkv, D) int8 or fp8-e4m3;
// k_scales/v_scales (Ps, page_size, Hkv) f32; block_tables and
// scale_tables (S, n_pages); the four (S,) int32 arrays. window <= 0 means
// no window. The wrapper checks D % 4 == 0, D <= 128, H % Hkv == 0 and
// 16 % (H / Hkv) == 0, that q and out are 16-byte and the value pools
// 4-byte aligned. Return the cudaError_t of cudaGetLastError() right
// after the launch.
extern "C" int paged_attention_ragged_quant_i8(
    const float* q, const int8_t* k_pages, const int8_t* v_pages,
    const float* k_scales, const float* v_scales, const int* block_tables,
    const int* scale_tables, const int* context_lens, const int* q_starts,
    const int* q_lens, const int* pos0, float* out, int T, int H, int Hkv,
    int D, int page_size, int S, int n_pages, int window, float scale,
    void* stream) {
  return attn_tile::launch_ragged<int8_t>(
      q, k_pages, v_pages, k_scales, v_scales, block_tables, scale_tables,
      context_lens, q_starts, q_lens, pos0, out, T, H, Hkv, D, page_size, S,
      n_pages, window, scale, stream);
}

extern "C" int paged_attention_ragged_quant_f8(
    const float* q, const __nv_fp8_e4m3* k_pages,
    const __nv_fp8_e4m3* v_pages, const float* k_scales,
    const float* v_scales, const int* block_tables, const int* scale_tables,
    const int* context_lens, const int* q_starts, const int* q_lens,
    const int* pos0, float* out, int T, int H, int Hkv, int D, int page_size,
    int S, int n_pages, int window, float scale, void* stream) {
  return attn_tile::launch_ragged<__nv_fp8_e4m3>(
      q, k_pages, v_pages, k_scales, v_scales, block_tables, scale_tables,
      context_lens, q_starts, q_lens, pos0, out, T, H, Hkv, D, page_size, S,
      n_pages, window, scale, stream);
}
