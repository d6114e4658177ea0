// Batched paged attention, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention
//   (grid body _kernel, grid (B, Hkv, n_pages)).
// Same contract as repro_torch/kernels/ref.py::paged_attention_ref:
// q (B, Tq, H, D); row (b, t) sits at the GLOBAL position
// q_pos = q_starts[b] + t (not an offset into a packed stream, as in the
// ragged kernel) and attends to every kv_pos with kv_pos < context_lens[b],
// kv_pos <= q_pos and, with a window, q_pos - kv_pos < window, reading K/V
// through block_table[b, kv_pos / page]. Every row (b, t) is computed and
// written; a row with no visible key gives exactly 0.
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
// Design. The Pallas kernel walks every page of the table in a sequential
// grid dimension, carrying the online softmax in scratch; on the GPU each
// block owns one (tile of 16 query vectors out of the Tq x G of one KV
// head, KV head, sequence) and loops over the keys itself, in the tile body
// shared with the ragged kernel (attention_tile.cuh). It reads only the
// keys the tile can see, from the window's first key to
// min(context_len, last q_pos + 1): table columns past the context point at
// trash page 0 and slots outside the range hold garbage, and neither is
// ever loaded. At Tq = 1 a block holds only G = 4 vectors, so one warp
// works and the grid is B x Hkv blocks: splitting the key range across
// blocks (flash-decoding) is later work.
#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

__global__ void __launch_bounds__(kThreads)
batched_paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ context_lens, const int* __restrict__ q_starts,
    float* __restrict__ out, int Tq, int H, int Hkv, int D, int page_size,
    int n_pages, int window, float scale) {
  const int rows_per_tile = kVecs / (H / Hkv);
  const int t0 = blockIdx.x * rows_per_tile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row0 = (size_t)b * Tq + t0;
  attend_tile<float>(q + row0 * H * D, out + row0 * H * D,
                     min(rows_per_tile, Tq - t0), q_starts[b] + t0,
                     context_lens[b], block_table + (size_t)b * n_pages,
                     n_pages, k_pages, v_pages, nullptr, nullptr, nullptr, H,
                     Hkv, D, page_size, hk, window, scale);
}

}  // namespace

// Plain C launcher (bound with ctypes). Shapes: q/out (B, Tq, H, D); pools
// (P, page_size, Hkv, D); block_table (B, n_pages); context_lens and
// q_starts (B,) int32. window <= 0 means no window. The wrapper checks that
// D % 4 == 0, D <= 128, H % Hkv == 0 and 16 % (H / Hkv) == 0, B <= 65535,
// and that q, the pools and out are 16-byte aligned. Returns the
// cudaError_t of cudaGetLastError() right after the launch.
extern "C" int paged_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* block_table, const int* context_lens, const int* q_starts,
    float* out, int B, int Tq, int H, int Hkv, int D, int page_size,
    int n_pages, int window, float scale, void* stream) {
  const int rows_per_tile = kVecs / (H / Hkv);
  const dim3 grid((Tq + rows_per_tile - 1) / rows_per_tile, Hkv, B);
  batched_paged_attention_kernel<<<grid, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      q, k_pages, v_pages, block_table, context_lens, q_starts, out, Tq, H,
      Hkv, D, page_size, n_pages, window, scale);
  return static_cast<int>(cudaGetLastError());
}
