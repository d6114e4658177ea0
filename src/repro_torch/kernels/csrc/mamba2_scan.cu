// Mamba2 SSD chunk scan, fp32 and bf16 inputs, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mamba2_scan.py::mamba_chunk_scan (grid body _kernel).
// Same contract as repro_torch/kernels/ref.py::mamba_chunk_scan_ref, which
// is the model's ssd_chunked: xdt (B, NC, L, H, P), a_dt (B, NC, L, H),
// b and c (B, NC, L, N), an optional initial state (B, H, P, N); out y
// (B, NC, L, H, P) and the state after the last chunk (B, H, P, N), the
// model's convention. Per chunk of L steps, with acum = cumsum(a):
//
//   y      = (C Bᵀ ⊙ tril(exp(acum_i − acum_j))) X + (C · state) ⊙ exp(acum)
//   state ← state · exp(acum_L) + (B ⊙ exp(acum_L − acum))ᵀ X
//
// The TPU kernel starts from a zero state; this one takes an initial state
// (the model seeds a prefill's scan from its cache), and writes the state
// in the model's layout itself where the TPU op transposes it.
//
// Where it runs: every Mamba2 block's prefill and training forward
// (models/mamba2.py::mamba_seq → ssd_chunked → ops.mamba_chunk_scan_op →
// kernels/mamba2_scan.py::MambaChunkScan), the backward below in training;
// decode steps run the one-step recurrence as tensor ops.
//
// What bounds it on the H100: per chunk and head L(L+1)/2·P FMAs for the
// masked scores times X, L·N·P for C · state and L·N·P for the chunk's
// state, against L·P floats of X read and L·P of y written: at L = N = 128,
// P = 64 about 40 FLOPs a byte, above the fp32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/B, so the fp32 FMAs on the CUDA cores bound it (no
// tensor cores: the reference is fp32, and TF32 keeps about three digits).
// An FFMA-bound body needs (i) a register tile whose FMAs outnumber its
// shared-memory loads about 4 to 1 (8 x 8 outputs a thread), (ii) enough
// warps on each SM to hide the loads and the barriers, (iii) no FMAs on
// what the causal mask discards, spread evenly over the warps, and (iv)
// the next tiles in flight while the FMAs run.
//
// Design. The TPU grid walks (B, H, NC) with the chunk innermost and
// carries the state in VMEM across grid steps. Blocks on the card run in
// no order, so the work is split the way ssd_chunked splits it, into four
// launches on the caller's stream:
//   1. chunk_prep: per (batch, chunk) and 32-row quarter of the chunk,
//      acum for every head into a scratch (B, NC, H, LP) (LP = L rounded
//      up to 4) and the chunk's decay exp(acum_L) into (B, NC, H); Cᵀ into
//      (B, NC, N, LP); and G = C Bᵀ once for all heads, on the 32 x 32
//      tiles at or below the diagonal only, transposed into (B, NC, L, LP)
//      (8.4 MB at 8 x 2048 tokens: it stays in L2 for launch 4).
//   2. chunk_state: each chunk's own end state from a zero start,
//      Bᵀ (w ⊙ X) with w = exp(acum_L − acum), into a scratch (B, NC, H,
//      N, P).
//   3. state_pass: one thread per 4 state elements walks the chunks in
//      order, overwriting each chunk's own state with the state carried
//      into it and writing the final state; it keeps 16 chunks' loads in
//      flight throughout, so that enough bytes are in flight to stream
//      the scratch at the memory's rate.
//   4. chunk_scan: y = exp(acum) ⊙ (C · state) + M X, M = G ⊙ decay.
// Launches 2 and 4 share one body: a block of 4 warps walks HB heads of
// one (batch, chunk) (HB from the wrapper's plan, so that the grid makes
// at least two waves) as one flat list of 32-deep k slabs — launch 2: the
// chunk's steps j (A = B's rows, B = X's rows); launch 4: first the state
// columns n (A = Cᵀ, B = the carried state), then the causal key slabs j
// (A = Gᵀ, B = X). Each thread holds 8 x 8 outputs: rows 32R + 2y + {0,1}
// for the four 32-row quarters R, columns 4c + {0..3} and 32 + 4c +
// {0..3}. A key slab s touches only the quarters R >= s, and every thread
// has two rows in each quarter, so every warp does the same FMAs in every
// slab; the quarters above the diagonal are neither loaded nor multiplied.
// Slabs arrive by cp.async into two stage buffers (24 KB each): while a
// slab's FMAs run the next slab — across a head boundary, the next head's
// tiles and its acum — is in flight. A thread applies the slab's factors
// to the elements it copied itself as soon as its copies land (launch 2:
// w_j on X's row j; launch 4: exp(acum_i − acum_j) and the mask on Gᵀ's
// entries), so the one barrier a slab both publishes the slab and frees
// the other buffer: 8 barriers a head at L = N = 128. acum arrives one
// head ahead into a ring of three slots. Shared memory of 2 and 4: 49.5
// KB, four blocks (16 warps) an SM within 128 registers a thread. Tiles
// are zero past L and N in k, so any L of 1 to 128 works; rows and
// columns past L and P are computed and not stored. Offsets are 64-bit.
// Every output is a fixed FMA chain, the same on every run.
//
// The backward (mamba2_scan_bwd_f32; the TPU package has no Pallas
// backward: its training differentiates the einsum ssd_chunked, and this
// is that einsum's VJP). It reads what the forward left in its scratch —
// the carried states, acum, decay and Gᵀ — and the forward's y, and
// mirrors the forward's split in five launches:
//   1. bwd_state (launch 2's body, weights exp(acum)): each chunk's own
//      dS term U = Cᵀ (exp(acum) ⊙ dY), (B, NC, H, N, P);
//   2. bwd_pass (launch 3's body, from the last chunk): U replaced by D =
//      dS_{c+1} (dfinal behind the last chunk), dS_0 the initial state's
//      gradient;
//   3. bwd_chunk: a block per (batch, chunk, head): dX, dG = (dY Xᵀ) ⊙
//      exp(acum_i − acum_j) on i >= j into a scratch, and da (see the
//      kernel);
//   4. bwd_dg_sum: Σ_h dG in head order;
//   5. bwd_bc: dB and dC, 64 rows a block, Σ_h dG times C or B once per
//      chunk (B and C are shared by the heads, so the L x L x N product is
//      not one per head) plus the heads' state terms in head order.
// What bounds it: about 2·L²·P + 8·L·N·P FLOPs a (batch, chunk, head), as
// the forward fp32 FMA-bound. This first version is plain: 16 x 16
// threads over one 32-deep slab in shared memory at a time, synchronous
// loads, the causal tiles of dY Xᵀ and Mᵀ dY formed whole and masked by a
// select (B7 makes it fast). No atomics: every sum has one order, so a
// repeat is bitwise equal.
//
// bf16. The Pallas kernel casts its blocks to fp32 and writes y in xdt's
// dtype, the state in fp32; the model's ssd_chunked casts xdt, a_dt, b and
// c to fp32 and returns fp32 y, and its mamba_seq hands it fp32 xdt and
// a_dt with b and c in the compute dtype. So the inputs come in two types,
// TX (xdt and a_dt) and TB (b and c), each fp32 or bf16, and y in TY; the
// launchers below instantiate (TX, TB, TY) = (f32, f32, f32), (f32, bf16,
// f32) (the model's at bf16 compute) and (bf16, bf16, bf16) (the kernel's
// contract); the backward takes f32 xdt and a_dt (the model's) with TB
// b and c, and reads y in f32.
// bf16 is widened to fp32 exactly where it is loaded (a bf16 is the top
// half of its fp32): launches 2 and 4 copy 4 values by an 8-byte cp.async
// into the first half of their fp32 slot and the copying thread widens
// the slot in place when its copies land, before the slab's one barrier;
// launch 1 and the backward load and widen directly. Scratch, states and
// every sum stay fp32; y, and the backward's dxdt, da_dt, db and dc, are
// rounded once to their input's type (round to nearest even: the VJP of
// astype(f32)). dY is fp32 (the model's y is).
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LT = 128;                 // most steps a chunk may have
constexpr int NT = 128;                 // widest state (N)
constexpr int PT = 64;                  // widest head (P)
constexpr int KS = 32;                  // k rows of a slab
constexpr int kThreads = 128;           // launches 2 and 4: 4 warps
constexpr int kBlocksPerSM = 4;         // 16 warps an SM
constexpr int kPrepThreads = 256;
constexpr int kPassThreads = 256;
constexpr int kAcumSlots = 3;
constexpr int kAFloats = KS * LT;       // an A slab [KS][LT]
constexpr int kStageFloats = kAFloats + KS * PT;   // + a B slab [KS][PT]
constexpr int kPipeBytes = (2 * kStageFloats + kAcumSlots * LT) * 4;
constexpr int CSTR = NT + 4;            // row stride of launch 1's tiles
constexpr int kPrepBytes = (32 + LT) * CSTR * 4;
static_assert(kPipeBytes == 50688, "the plan states 50688 bytes");
static_assert(kPrepBytes == 84480, "the plan states 84480 bytes");
static_assert(kBlocksPerSM * (kPipeBytes + 1024) <= 233472,
              "four blocks of launches 2 and 4 exceed an SM's shared memory");

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

using bf16 = __nv_bfloat16;
template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ void cp8(float* dst, const bf16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float4 widen4(uint2 g) {  // 4 bf16, exactly
  return make_float4(__uint_as_float(g.x << 16),
                     __uint_as_float(g.x & 0xffff0000u),
                     __uint_as_float(g.y << 16),
                     __uint_as_float(g.y & 0xffff0000u));
}

// 4 consecutive input values into an fp32 slot of shared memory by
// cp.async: fp32 whole; bf16 into the slot's first 8 bytes, for widen_slot
// once the copy has landed
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  cp16(dst, src);
}

__device__ __forceinline__ void cp4(float* dst, const bf16* src) {
  cp8(dst, src);
}

template <typename T>
__device__ __forceinline__ void widen_slot(float* slot) {
  if constexpr (kBf16<T>)
    *reinterpret_cast<float4*>(slot) =
        widen4(*reinterpret_cast<const uint2*>(slot));
}

// 4 consecutive input values into an fp32 slot, synchronously for bf16
__device__ __forceinline__ void load4(float* dst, const float* src) {
  cp16(dst, src);
}

__device__ __forceinline__ void load4(float* dst, const bf16* src) {
  *reinterpret_cast<float4*>(dst) =
      widen4(*reinterpret_cast<const uint2*>(src));
}

// one input value as fp32, and one output value in its type (bf16 rounded
// once to nearest even)
__device__ __forceinline__ float ldf(const float* p) { return *p; }

__device__ __forceinline__ float ldf(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void put1(float* p, float v) { *p = v; }

__device__ __forceinline__ void put1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void put4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void put4(bf16* p, float a, float b, float c,
                                     float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// ---------------------------------------------------------------------------
// launch 1: acum, decay, Cᵀ and the causal tiles of Gᵀ

template <typename TX, typename TB>
__global__ void __launch_bounds__(kPrepThreads)
chunk_prep_kernel(const TX* __restrict__ a, const TB* __restrict__ bm,
                  const TB* __restrict__ cm, float* __restrict__ acum,
                  float* __restrict__ decay, float* __restrict__ ct,
                  float* __restrict__ gt, int NC, int L, int H, int N,
                  int LP) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;             // [32][CSTR]: C rows i0 .. i0 + 31
  float* bs = cs + 32 * CSTR;   // [LT][CSTR]: B rows 0 .. jmax - 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x, i0 = 32 * q;
  const size_t bc = static_cast<size_t>(blockIdx.z) * NC + blockIdx.y;
  const int jmax = min(L, i0 + 32);  // keys of the tiles at or below the diagonal

  for (int e = tid; e < 32 * (NT / 4); e += kPrepThreads) {
    const int r = e >> 5, c4 = e & 31, i = i0 + r;
    float* d = cs + r * CSTR + 4 * c4;
    if (i < L && 4 * c4 < N)
      load4(d, cm + (bc * L + i) * N + 4 * c4);
    else
      zero4(d);
  }
  for (int e = tid; e < jmax * (NT / 4); e += kPrepThreads) {
    const int j = e >> 5, c4 = e & 31;
    if (4 * c4 < N)
      load4(bs + j * CSTR + 4 * c4, bm + (bc * L + j) * N + 4 * c4);
  }
  commit();

  // acum of heads q·8 + warp, every 8·gridDim.x: lane-local runs of 4, then
  // a shuffle scan of the lane totals; past L it stays at acum_{L-1}
  for (int h = q * 8 + warp; h < H; h += 8 * gridDim.x) {
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = lane * 4 + k;
      run += l < L ? ldf(a + (bc * L + l) * H + h) : 0.f;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] += excl;
    if (4 * lane < LP)
      *reinterpret_cast<float4*>(acum + (bc * H + h) * LP + 4 * lane) =
          make_float4(v[0], v[1], v[2], v[3]);
    if (lane == 31) decay[bc * H + h] = expf(v[3]);
  }
  copies_done();
  __syncthreads();

  for (int e = tid; e < N * 32; e += kPrepThreads) {  // Cᵀ[n][i]
    const int n = e >> 5, il = e & 31;
    if (i0 + il < LP) ct[(bc * N + n) * LP + i0 + il] = cs[il * CSTR + n];
  }
  // Gᵀ[j][i] = Σ_n C[i][n] B[j][n] for i in this quarter and the keys j of
  // the tiles at or below the diagonal; a lane takes one i, four j at once
  for (int jb = warp; jb < jmax; jb += 32) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int n = 0; n < N; n += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(cs + lane * CSTR + n);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 bv = *reinterpret_cast<const float4*>(
            bs + min(jb + 8 * u, jmax - 1) * CSTR + n);
        float t = fmaf(cv.x, bv.x, s[u]);
        t = fmaf(cv.y, bv.y, t);
        t = fmaf(cv.z, bv.z, t);
        s[u] = fmaf(cv.w, bv.w, t);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = jb + 8 * u;
      if (j < jmax && i0 + lane < LP) gt[(bc * L + j) * LP + i0 + lane] = s[u];
    }
  }
}

// ---------------------------------------------------------------------------
// launches 2 and 4: the slab body

// acc[R][e][q] += Σ_k A[k][32R + 2y + e] · B[k][col q] over one slab, for
// the quarters R >= R0 (those below a key slab's diagonal); `as` points at
// the slab's A + 2y, `bs` at its B + 4c
template <int R0>
__device__ __forceinline__ void fma_slab(float (&acc)[4][2][8],
                                         const float* __restrict__ as,
                                         const float* __restrict__ bs) {
#pragma unroll 2  // unrolled further, the 4 variants outgrow the i-cache
  for (int k = 0; k < KS; ++k) {
    float2 av[4];
#pragma unroll
    for (int r = R0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float2*>(as + k * LT + 32 * r);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + k * PT);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + k * PT + 32);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = R0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        acc[r][0][q] = fmaf(av[r].x, bv[q], acc[r][0][q]);
        acc[r][1][q] = fmaf(av[r].y, bv[q], acc[r][1][q]);
      }
  }
}

__device__ __forceinline__ void fma_key_slab(int s, float (&acc)[4][2][8],
                                             const float* as,
                                             const float* bs) {
  switch (s) {
    case 0: fma_slab<0>(acc, as, bs); break;
    case 1: fma_slab<1>(acc, as, bs); break;
    case 2: fma_slab<2>(acc, as, bs); break;
    default: fma_slab<3>(acc, as, bs); break;
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][2][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][e][q] = 0.f;
}

// rows 32R + ay + e below `rows` and columns bx + {0..3}, 32 + bx + {0..3}
// below P of a row-major output whose rows are `stride` values apart
template <typename OT>
__device__ __forceinline__ void store_tile(const float (&acc)[4][2][8],
                                           OT* out, size_t stride,
                                           int rows, int P, int ay, int bx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 32 * r + ay + e;
      if (i >= rows) continue;
      OT* o = out + i * stride;
      if (bx < P)
        put4(o + bx, acc[r][e][0], acc[r][e][1], acc[r][e][2], acc[r][e][3]);
      if (32 + bx < P)
        put4(o + 32 + bx, acc[r][e][4], acc[r][e][5], acc[r][e][6],
             acc[r][e][7]);
    }
}

// copy acum of head h (LP floats) into a slot; the caller commits
__device__ __forceinline__ void load_acum(float* slot, const float* acum,
                                          size_t bc, int H, int h, int LP) {
  if (static_cast<int>(threadIdx.x) < LP / 4)
    cp16(slot + 4 * threadIdx.x, acum + (bc * H + h) * LP + 4 * threadIdx.x);
}

// launch 2: states[b, c, h] (N x P, zero start) for HB heads. With kGrad
// it is the backward's launch 1 instead (bwd_state_kernel): x is dY, bm is
// C, and the weight of step j is exp(acum_j), so it writes U = Cᵀ
// (exp(acum) ⊙ dY)
template <bool kGrad, typename TX, typename TB>
__device__ __forceinline__ void chunk_state_body(
    const TX* __restrict__ x, const TB* __restrict__ bm,
    const float* __restrict__ acum, float* __restrict__ states, int NC,
    int L, int H, int P, int N, int LP, int HB) {
  extern __shared__ __align__(16) float smem[];
  float* slots = smem + 2 * kStageFloats;  // [kAcumSlots][LT]
  const int tid = threadIdx.x, lane = tid & 31;
  const int ay = 2 * (4 * (tid >> 5) + (lane >> 3)), bx = 4 * (lane & 7);
  const size_t bc = static_cast<size_t>(blockIdx.z) * NC + blockIdx.y;
  const int h0 = blockIdx.x * HB, nh = min(HB, H - h0);
  const int ns = (L + KS - 1) / KS;
  const size_t xrow = static_cast<size_t>(H) * P;

  // slab u of head h0 + hh (steps from 32u) into stage buffer `buf`
  auto fetch = [&](int buf, int hh, int u) {
    float* as = smem + buf * kStageFloats;
    float* bs = as + kAFloats;
    const int j0 = u * KS;
#pragma unroll
    for (int q = 0; q < 8; ++q) {   // B[j][n]
      const int k = (tid >> 5) + 4 * q, c4 = tid & 31, j = j0 + k;
      float* d = as + k * LT + 4 * c4;
      if (j >= L)
        zero4(d);
      else if (4 * c4 < N)
        cp4(d, bm + (bc * L + j) * N + 4 * c4);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // X[j][p]
      const int k = (tid >> 4) + 8 * q, c4 = tid & 15, j = j0 + k;
      float* d = bs + k * PT + 4 * c4;
      if (j >= L)
        zero4(d);
      else if (4 * c4 < P)
        cp4(d, x + (bc * L + j) * xrow + static_cast<size_t>(h0 + hh) * P +
                   4 * c4);
    }
    if (u == ns - 1 && hh + 1 < nh)
      load_acum(slots + ((hh + 1) % kAcumSlots) * LT, acum, bc, H, h0 + hh + 1,
                LP);
  };
  // bf16 B rows this thread copied widened in place; then w_j =
  // exp(acum_L − acum_j) (kGrad: exp(acum_j)) on the rows of X it copied
  // (widened first)
  auto weigh = [&](int buf, int hh, int u) {
    float* bs = smem + buf * kStageFloats + kAFloats;
    const int j0 = u * KS;
    const float* ac = slots + (hh % kAcumSlots) * LT;
    const float last = ac[L - 1];
    if constexpr (kBf16<TB>) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int k = (tid >> 5) + 4 * q, c4 = tid & 31, j = j0 + k;
        if (j < L && 4 * c4 < N)
          widen_slot<TB>(smem + buf * kStageFloats + k * LT + 4 * c4);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = (tid >> 4) + 8 * q, c4 = tid & 15, j = j0 + k;
      if (j < L && 4 * c4 < P) {
        widen_slot<TX>(bs + k * PT + 4 * c4);
        float4* v = reinterpret_cast<float4*>(bs + k * PT + 4 * c4);
        const float w = __expf(kGrad ? ac[j] : last - ac[j]);
        float4 g = *v;
        g.x *= w;
        g.y *= w;
        g.z *= w;
        g.w *= w;
        *v = g;
      }
    }
  };

  float acc[4][2][8];
  zero_acc(acc);
  load_acum(slots, acum, bc, H, h0, LP);
  commit();
  copies_done();
  __syncthreads();
  fetch(0, 0, 0);
  commit();
  // slab u of head hh in buffer buf; the next one is (hn, un)
  for (int hh = 0, u = 0, buf = 0; hh < nh; buf ^= 1) {
    copies_done();
    weigh(buf, hh, u);
    __syncthreads();  // this slab whole; the last one's buffer free
    const int un = u + 1 == ns ? 0 : u + 1, hn = un == 0 ? hh + 1 : hh;
    if (hn < nh) fetch(buf ^ 1, hn, un);
    commit();
    const float* as = smem + buf * kStageFloats;
    fma_slab<0>(acc, as + ay, as + kAFloats + bx);
    if (un == 0) {
      store_tile(acc,
                 states + (bc * H + h0 + hh) * static_cast<size_t>(N) * P,
                 P, N, P, ay, bx);
      zero_acc(acc);
    }
    hh = hn;
    u = un;
  }
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
chunk_state_kernel(const TX* __restrict__ x, const TB* __restrict__ bm,
                   const float* __restrict__ acum, float* __restrict__ states,
                   int NC, int L, int H, int P, int N, int LP, int HB) {
  chunk_state_body<false>(x, bm, acum, states, NC, L, H, P, N, LP, HB);
}

// launch 3: per 4 state elements (one n, 4 consecutive p), the chunks in
// order, each chunk's own state replaced by the state carried into it. A
// thread keeps kPass chunks' 16-byte loads in flight all the way: the
// load of chunk c + kPass starts as soon as chunk c's is consumed, in
// the register chunk c freed (the loop is unrolled kPass chunks at a time
// so that the ring's registers have fixed names). kRev walks the chunks
// from the last one: the backward's launch 2 (bwd_pass_kernel), which
// replaces each chunk's U with dS_{c+1}, the gradient carried into the
// chunk from behind, and writes dS_0 (s0: dfinal, sout: the initial
// state's gradient, or null)
constexpr int kPass = 16;

template <bool kRev>
__device__ __forceinline__ void state_pass_body(
    float* __restrict__ states, const float* __restrict__ decay,
    const float* __restrict__ s0, float* __restrict__ sout, int B, int NC,
    int H, int P, int N) {
  const size_t np = static_cast<size_t>(N) * P;
  const size_t e =
      (static_cast<size_t>(blockIdx.x) * kPassThreads + threadIdx.x) * 4;
  if (e >= static_cast<size_t>(B) * H * np) return;
  const size_t bh = e / np;
  const int k = static_cast<int>(e % np);
  const int n = k / P, p = k % P;
  const size_t b = bh / H;
  const int h = static_cast<int>(bh % H);
  const size_t pn = (bh * P + p) * N + n;  // (B, H, P, N); p + i at + i·N
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (s0 != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = s0[pn + i * N];
  }
  const size_t cs = static_cast<size_t>(H) * np;  // floats between chunks
  float* base = states + (b * NC * H + h) * np + k;
  const float* dec = decay + b * NC * H + h;
  // the chunk the c-th step of the walk visits
  auto at = [&](int c) -> size_t { return kRev ? NC - 1 - c : c; };
  float4 own[kPass];
  float d[kPass];
#pragma unroll
  for (int i = 0; i < kPass; ++i) {
    if (i < NC) {
      own[i] = *reinterpret_cast<const float4*>(base + at(i) * cs);
      d[i] = dec[at(i) * H];
    }
  }
  for (int c0 = 0; c0 < NC; c0 += kPass) {
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      const int c = c0 + i;
      if (c < NC) {
        *reinterpret_cast<float4*>(base + at(c) * cs) =
            make_float4(s[0], s[1], s[2], s[3]);
        s[0] = s[0] * d[i] + own[i].x;
        s[1] = s[1] * d[i] + own[i].y;
        s[2] = s[2] * d[i] + own[i].z;
        s[3] = s[3] * d[i] + own[i].w;
        if (c + kPass < NC) {
          own[i] =
              *reinterpret_cast<const float4*>(base + at(c + kPass) * cs);
          d[i] = dec[at(c + kPass) * H];
        }
      }
    }
  }
  if (sout != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sout[pn + i * N] = s[i];
  }
}

__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                  const float* __restrict__ s0, float* __restrict__ sout,
                  int B, int NC, int H, int P, int N) {
  state_pass_body<false>(states, decay, s0, sout, B, NC, H, P, N);
}

// launch 4: y for one chunk and HB heads. zero_start: no initial state, so
// chunk 0 carries none in and skips C · state
template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
chunk_scan_kernel(const TX* __restrict__ x, const float* __restrict__ ct,
                  const float* __restrict__ gt, const float* __restrict__ acum,
                  const float* __restrict__ prev, TY* __restrict__ y,
                  int NC, int L, int H, int P, int N, int LP, int HB,
                  int zero_start) {
  extern __shared__ __align__(16) float smem[];
  float* slots = smem + 2 * kStageFloats;  // [kAcumSlots][LT]
  const int tid = threadIdx.x, lane = tid & 31;
  const int ay = 2 * (4 * (tid >> 5) + (lane >> 3)), bx = 4 * (lane & 7);
  const size_t bc = static_cast<size_t>(blockIdx.z) * NC + blockIdx.y;
  const int h0 = blockIdx.x * HB, nh = min(HB, H - h0);
  const int nst = zero_start && blockIdx.y == 0 ? 0 : (N + KS - 1) / KS;
  const int tph = nst + (L + KS - 1) / KS;
  const size_t xrow = static_cast<size_t>(H) * P;

  // slab u of head h0 + hh into stage buffer `buf`: the state slabs
  // n0 = 32u for u < nst, then the key slabs s = u − nst
  auto fetch = [&](int buf, int hh, int u) {
    float* as = smem + buf * kStageFloats;
    float* bs = as + kAFloats;
    const int h = h0 + hh;
    if (u < nst) {
      const int n0 = u * KS;
#pragma unroll
      for (int q = 0; q < 8; ++q) {  // Cᵀ[n][i]
        const int k = (tid >> 5) + 4 * q, i4 = tid & 31, n = n0 + k;
        float* d = as + k * LT + 4 * i4;
        if (n >= N)
          zero4(d);
        else if (4 * i4 < LP)
          cp16(d, ct + (bc * N + n) * LP + 4 * i4);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // the carried state [n][p]
        const int k = (tid >> 4) + 8 * q, c4 = tid & 15, n = n0 + k;
        float* d = bs + k * PT + 4 * c4;
        if (n >= N)
          zero4(d);
        else if (4 * c4 < P)
          cp16(d, prev + ((bc * H + h) * N + n) * static_cast<size_t>(P) +
                      4 * c4);
      }
    } else {
      const int s = u - nst, j0 = s * KS;
#pragma unroll
      for (int q = 0; q < 8; ++q) {  // Gᵀ[j][i], i in the quarters >= s
        const int k = (tid >> 5) + 4 * q, i4 = tid & 31, j = j0 + k;
        float* d = as + k * LT + 4 * i4;
        if (i4 < 8 * s) continue;
        if (j >= L)
          zero4(d);
        else if (4 * i4 < LP)
          cp16(d, gt + (bc * L + j) * LP + 4 * i4);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // X[j][p]
        const int k = (tid >> 4) + 8 * q, c4 = tid & 15, j = j0 + k;
        float* d = bs + k * PT + 4 * c4;
        if (j >= L)
          zero4(d);
        else if (4 * c4 < P)
          cp4(d, x + (bc * L + j) * xrow + static_cast<size_t>(h) * P +
                     4 * c4);
      }
    }
    if (u == tph - 1 && hh + 1 < nh)
      load_acum(slots + ((hh + 1) % kAcumSlots) * LT, acum, bc, H, h + 1, LP);
  };
  // M = Gᵀ ⊙ exp(acum_i − acum_j) for i >= j, else 0, on the entries of a
  // key slab this thread copied (and bf16 X rows it copied, widened)
  auto decay_mask = [&](int buf, int hh, int u) {
    if (u < nst) return;
    if constexpr (kBf16<TX>) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = (tid >> 4) + 8 * q, c4 = tid & 15;
        if ((u - nst) * KS + k < L && 4 * c4 < P)
          widen_slot<TX>(smem + buf * kStageFloats + kAFloats + k * PT +
                         4 * c4);
      }
    }
    const int s = u - nst, j0 = s * KS, i4 = tid & 31;
    if (i4 < 8 * s || 4 * i4 >= LP) return;
    float* as = smem + buf * kStageFloats;
    const float* ac = slots + (hh % kAcumSlots) * LT;
    const float4 ai = *reinterpret_cast<const float4*>(ac + 4 * i4);
    const int i = 4 * i4;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = (tid >> 5) + 4 * q, j = j0 + k;
      if (j >= L) continue;
      float4* v = reinterpret_cast<float4*>(as + k * LT + 4 * i4);
      const float aj = ac[j];
      float4 g = *v;
      g.x = i >= j ? g.x * __expf(ai.x - aj) : 0.f;
      g.y = i + 1 >= j ? g.y * __expf(ai.y - aj) : 0.f;
      g.z = i + 2 >= j ? g.z * __expf(ai.z - aj) : 0.f;
      g.w = i + 3 >= j ? g.w * __expf(ai.w - aj) : 0.f;
      *v = g;
    }
  };

  float acc[4][2][8];
  zero_acc(acc);
  load_acum(slots, acum, bc, H, h0, LP);
  commit();
  copies_done();
  __syncthreads();
  fetch(0, 0, 0);
  commit();
  // slab u of head hh in buffer buf; the next one is (hn, un)
  for (int hh = 0, u = 0, buf = 0; hh < nh; buf ^= 1) {
    copies_done();
    decay_mask(buf, hh, u);
    __syncthreads();  // this slab whole; the last one's buffer free
    const int un = u + 1 == tph ? 0 : u + 1, hn = un == 0 ? hh + 1 : hh;
    if (hn < nh) fetch(buf ^ 1, hn, un);
    commit();
    const float* as = smem + buf * kStageFloats + ay;
    const float* bs = smem + buf * kStageFloats + kAFloats + bx;
    if (u == nst && nst > 0) {  // C · state done: times exp(acum_i)
      const float* ac = slots + (hh % kAcumSlots) * LT + ay;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float f = __expf(ac[32 * r + e]);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][e][q] *= f;
        }
    }
    // a state slab takes every quarter, as key slab 0 does
    fma_key_slab(u < nst ? 0 : u - nst, acc, as, bs);
    if (un == 0) {
      store_tile(acc, y + bc * L * xrow + static_cast<size_t>(h0 + hh) * P,
                 xrow, L, P, ay, bx);
      zero_acc(acc);
    }
    hh = hn;
    u = un;
  }
}

// ---------------------------------------------------------------------------
// the backward: launches 3 to 5 (1 and 2 are bwd_state_kernel and
// bwd_pass_kernel, on the forward's bodies)

constexpr int kGradThreads = 256;       // 16 x 16 threads, 8 warps
constexpr int GLD = LT + 1;             // row stride of a grad slab: the
                                        // transposing stores hit 32 banks
constexpr int kRowTile = 64;            // launch 5: rows a block

// launch 1: U = Cᵀ (exp(acum) ⊙ dY) on launch 2's body
template <typename TB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
bwd_state_kernel(const float* __restrict__ dy, const TB* __restrict__ cm,
                 const float* __restrict__ acum, float* __restrict__ u,
                 int NC, int L, int H, int P, int N, int LP, int HB) {
  chunk_state_body<true>(dy, cm, acum, u, NC, L, H, P, N, LP, HB);
}

// launch 2: D = dS_{c+1} from the last chunk, on launch 3's body
__global__ void __launch_bounds__(kPassThreads)
bwd_pass_kernel(float* __restrict__ u, const float* __restrict__ decay,
                const float* __restrict__ dfinal, float* __restrict__ dinit,
                int B, int NC, int H, int P, int N) {
  state_pass_body<true>(u, decay, dfinal, dinit, B, NC, H, P, N);
}

// acc[r][q] += Σ_k A[k][ty + 16r] · B[k][tx + 16q] over one KS-deep slab of
// `as` and `bs` (both [KS][GLD], zero past their edges)
template <int R, int Q>
__device__ __forceinline__ void mm_slab(float (&acc)[R][Q],
                                        const float* __restrict__ as,
                                        const float* __restrict__ bs, int ty,
                                        int tx) {
#pragma unroll 4
  for (int k = 0; k < KS; ++k) {
    float av[R], bv[Q];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = as[k * GLD + ty + 16 * r];
#pragma unroll
    for (int q = 0; q < Q; ++q) bv[q] = bs[k * GLD + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

template <int R, int Q>
__device__ __forceinline__ void zero_tile(float (&acc)[R][Q]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[r][q] = 0.f;
}

// slab[k][r] = f(k, r) for k < KS and r < rows; k runs fastest, so a warp
// reads 32 consecutive k of one source row (a source contiguous in k)
template <typename F>
__device__ __forceinline__ void fill_by_k(float* slab, int rows, F f) {
  for (int e = threadIdx.x; e < KS * rows; e += kGradThreads) {
    const int k = e & (KS - 1), r = e / KS;
    slab[k * GLD + r] = f(k, r);
  }
}

// slab[k][r] = f(k, r) for k < KS and r < cols (a power of two); r runs
// fastest (a source contiguous in r)
template <int kCols, typename F>
__device__ __forceinline__ void fill_by_col(float* slab, F f) {
  for (int e = threadIdx.x; e < KS * kCols; e += kGradThreads) {
    const int r = e & (kCols - 1), k = e / kCols;
    slab[k * GLD + r] = f(k, r);
  }
}

// launch 3: one (batch, chunk, head) a block. With S the state carried into
// the chunk, D = dS_{c+1} (launch 2), M_ij = G_ij exp(acum_i − acum_j) on
// i >= j and w_j = exp(acum_L − acum_j):
//   dM = dY Xᵀ on i >= j, dG = dM ⊙ exp(acum_i − acum_j) into `dg`
//     (B, NC, H, L, L), zero above the diagonal;
//   dX = w ⊙ (B D) + Mᵀ dY;
//   dacum_i = Σ_p dY_ip y_ip − Σ_i' (dG ⊙ G)_i'i − T_i, T_j = Σ_p X_jp
//     (w ⊙ B D)_jp; at i = L−1 also + Σ_j T_j + exp(acum_L) Σ D ⊙ S;
//   da = the reverse cumulative sum of dacum.
// Σ_p dY ⊙ y stands for the row sums of dM ⊙ M plus Σ_p dY ⊙ y_off (y =
// M X + y_off), so neither C Sᵀ nor the row sums are formed.
template <typename TB>
__global__ void __launch_bounds__(kGradThreads)
bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  const float* __restrict__ y, const float* __restrict__ gt,
                  const TB* __restrict__ bm, const float* __restrict__ acum,
                  const float* __restrict__ decay,
                  const float* __restrict__ states,
                  const float* __restrict__ dstates, float* __restrict__ dx,
                  float* __restrict__ dg, float* __restrict__ da, int NC,
                  int L, int H, int P, int N, int LP) {
  __shared__ float as[KS * GLD];
  __shared__ float bs[KS * GLD];
  __shared__ float part[16 * LT];  // per ty: column sums of dG ⊙ G
  __shared__ float ac[LT];         // acum of this head
  __shared__ float dA[LT];
  __shared__ float tj[LT];
  __shared__ float red[kGradThreads / 32];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x;
  const size_t bc = static_cast<size_t>(blockIdx.z) * NC + blockIdx.y;
  const size_t bch = bc * H + h;
  const size_t xrow = static_cast<size_t>(H) * P;
  const size_t head = bc * L * xrow + static_cast<size_t>(h) * P;
  const float* xh = x + head;      // row i at + i·xrow
  const float* dyh = dy + head;
  const float* yh = y + head;
  const float* g = gt + bc * L * LP;  // Gᵀ[j][i] at g[j·LP + i]
  const TB* bb = bm + bc * L * N;
  const float* sh = states + bch * N * P;  // [n][p]
  const float* dh = dstates + bch * N * P;
  for (int i = tid; i < LT; i += kGradThreads) {
    ac[i] = i < L ? acum[bch * LP + i] : 0.f;
    dA[i] = 0.f;
  }
  __syncthreads();
  const float last = ac[L - 1];

  // dM = dY Xᵀ, k = p
  float acc[8][8];
  zero_tile(acc);
  for (int p0 = 0; p0 < P; p0 += KS) {
    fill_by_k(as, LT, [&](int k, int r) {
      return r < L && p0 + k < P ? dyh[r * xrow + p0 + k] : 0.f;
    });
    fill_by_k(bs, LT, [&](int k, int r) {
      return r < L && p0 + k < P ? ldf(xh + r * xrow + p0 + k) : 0.f;
    });
    __syncthreads();
    mm_slab(acc, as, bs, ty, tx);
    __syncthreads();
  }
  float* dgh = dg + bch * L * L;
  float colp[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) colp[q] = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = tx + 16 * q;
      float v = 0.f, qv = 0.f;
      if (i < L && j <= i) {   // a select: exp above the diagonal may be inf
        v = acc[r][q] * expf(ac[i] - ac[j]);
        qv = v * g[j * LP + i];
      }
      if (i < L && j < L) dgh[i * L + j] = v;
      colp[q] += qv;
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) part[ty * LT + tx + 16 * q] = colp[q];
  __syncthreads();
  if (tid < L) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += part[t * LT + tid];
    dA[tid] = -s;
  }

  // dX: the state slabs (k = n: Bᵀ and D), times w_j, then the key slabs
  // (k = i: M and dY)
  float acx[8][4];
  zero_tile(acx);
  for (int n0 = 0; n0 < N; n0 += KS) {
    fill_by_k(as, LT, [&](int k, int r) {
      return r < L && n0 + k < N ? ldf(bb + r * N + n0 + k) : 0.f;
    });
    fill_by_col<PT>(bs, [&](int k, int c) {
      return n0 + k < N && c < P ? dh[(n0 + k) * P + c] : 0.f;
    });
    __syncthreads();
    mm_slab(acx, as, bs, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = ty + 16 * r;
    const float w = j < L ? expf(last - ac[j]) : 0.f;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acx[r][q] *= w;
      const int p = tx + 16 * q;
      if (j < L && p < P) t = fmaf(ldf(xh + j * xrow + p), acx[r][q], t);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (tx == 0 && j < L) {   // this thread's own rows: no other writer
      tj[j] = t;
      dA[j] -= t;
    }
  }
  for (int i0 = 0; i0 < L; i0 += KS) {
    fill_by_k(as, LT, [&](int k, int r) {   // M[i0 + k][r]
      const int i = i0 + k;
      return i < L && r <= i ? g[r * LP + i] * expf(ac[i] - ac[r]) : 0.f;
    });
    fill_by_col<PT>(bs, [&](int k, int c) {
      return i0 + k < L && c < P ? dyh[(i0 + k) * xrow + c] : 0.f;
    });
    __syncthreads();
    mm_slab(acx, as, bs, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = tx + 16 * q;
      if (j < L && p < P) put1(dx + head + j * xrow + p, acx[r][q]);
    }
  }

  // dacum: + Σ_p dY ⊙ y a row (a warp a row); Σ D ⊙ S and Σ_j T_j at L−1
  for (int i = warp; i < L; i += kGradThreads / 32) {
    float s = 0.f;
    for (int p = lane; p < P; p += 32)
      s = fmaf(dyh[i * xrow + p], yh[i * xrow + p], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) dA[i] += s;
  }
  float ds = 0.f;
  for (int e = tid; e < N * P; e += kGradThreads) ds = fmaf(dh[e], sh[e], ds);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ds += __shfl_xor_sync(0xffffffffu, ds, o);
  if (lane == 0) red[warp] = ds;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f, ts = 0.f;
    for (int w = 0; w < kGradThreads / 32; ++w) tot += red[w];
    for (int j = 0; j < L; ++j) ts += tj[j];
    dA[L - 1] += ts + decay[bch] * tot;
  }
  __syncthreads();
  // da_i = Σ_{i' >= i} dacum_i': lane-local runs of 4 from the top, then a
  // shuffle scan of the lane totals from the last lane down
  if (warp == 0) {
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const int l = 4 * lane + k;
      run += l < L ? dA[l] : 0.f;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += t;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = 4 * lane + k;
      if (l < L) put1(da + (bc * L + l) * H + h, v[k] + excl);
    }
  }
}

// launch 4: Σ_h dG over the heads in order, one element a thread
__global__ void __launch_bounds__(kPassThreads)
bwd_dg_sum_kernel(const float* __restrict__ dg, float* __restrict__ dgs, int H,
              size_t ll, size_t total) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kPassThreads +
                   threadIdx.x;
  if (e >= total) return;
  const float* src = dg + (e / ll) * H * ll + e % ll;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += src[h * ll];
  dgs[e] = s;
}

// launch 5: kRowTile rows of dC (blockIdx.x even) or dB (odd) of one
// (batch, chunk), N columns; the heads in order, so every sum has one order:
//   dC = Σ_h dG_h B + Σ_h (exp(acum_h) ⊙ dY_h) S_hᵀ,
//   dB = Σ_h dG_hᵀ C + Σ_h (w_h ⊙ X_h) D_hᵀ,
// the first term over the L keys of Σ_h dG (launch 4), the second over the
// H·P pairs (h, p), one 32-deep slab of p at a time
template <typename TB>
__global__ void __launch_bounds__(kGradThreads)
bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ dy,
               const TB* __restrict__ bm, const TB* __restrict__ cm,
               const float* __restrict__ acum,
               const float* __restrict__ states,
               const float* __restrict__ dstates,
               const float* __restrict__ dgs, TB* __restrict__ db,
               TB* __restrict__ dc, int NC, int L, int H, int P, int N,
               int LP) {
  __shared__ float as[KS * GLD];
  __shared__ float bs[KS * GLD];
  __shared__ float ex[kRowTile];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool is_b = blockIdx.x & 1;
  const int r0 = (blockIdx.x >> 1) * kRowTile;
  const size_t bc = static_cast<size_t>(blockIdx.z) * NC + blockIdx.y;
  const size_t xrow = static_cast<size_t>(H) * P;
  const float* gs = dgs + bc * L * L;              // Σ_h dG [i][j]
  const TB* other = (is_b ? cm : bm) + bc * L * N;
  const float* xs = x + bc * L * xrow;  // dB's source, X
  const float* dys = dy + bc * L * xrow;   // dC's, dY
  const float* st = is_b ? dstates : states;
  float acc[4][8];
  zero_tile(acc);
  for (int k0 = 0; k0 < L; k0 += KS) {
    if (is_b)   // A[k][r] = Σ dG[k0 + k][r0 + r]
      fill_by_col<kRowTile>(as, [&](int k, int r) {
        return k0 + k < L && r0 + r < L ? gs[(k0 + k) * L + r0 + r] : 0.f;
      });
    else        // A[k][r] = Σ dG[r0 + r][k0 + k]
      fill_by_k(as, kRowTile, [&](int k, int r) {
        return k0 + k < L && r0 + r < L ? gs[(r0 + r) * L + k0 + k] : 0.f;
      });
    fill_by_col<NT>(bs, [&](int k, int n) {
      return k0 + k < L && n < N ? ldf(other + (k0 + k) * N + n) : 0.f;
    });
    __syncthreads();
    mm_slab(acc, as, bs, ty, tx);
    __syncthreads();
  }
  for (int h = 0; h < H; ++h) {
    const size_t bch = bc * H + h;
    if (tid < kRowTile) {
      const int i = r0 + tid;
      const float* a = acum + bch * LP;
      ex[tid] = i >= L ? 0.f : expf(is_b ? a[L - 1] - a[i] : a[i]);
    }
    __syncthreads();
    const float* sh = st + bch * N * P;
    for (int p0 = 0; p0 < P; p0 += KS) {
      fill_by_k(as, kRowTile, [&](int k, int r) {
        const int i = r0 + r;
        if (!(i < L && p0 + k < P)) return 0.f;
        const size_t at = i * xrow + static_cast<size_t>(h) * P + p0 + k;
        return ex[r] * (is_b ? ldf(xs + at) : dys[at]);
      });
      fill_by_k(bs, NT, [&](int k, int n) {
        return n < N && p0 + k < P ? sh[n * P + p0 + k] : 0.f;
      });
      __syncthreads();
      mm_slab(acc, as, bs, ty, tx);
      __syncthreads();
    }
  }
  TB* out = (is_b ? db : dc) + bc * L * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      if (i < L && n < N) put1(out + i * N + n, acc[r][q]);
    }
  }
}

// The dynamic shared memory and carve-out of one instantiation's launches
// 1, 2 and 4 (and the backward's launch 1) on the current device.
template <typename TX, typename TB, typename TY>
void set_attributes() {
  const auto pipe = [](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kPipeBytes);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
  };
  cudaFuncSetAttribute(chunk_prep_kernel<TX, TB>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kPrepBytes);
  pipe(chunk_state_kernel<TX, TB>);
  pipe(chunk_scan_kernel<TX, TY>);
  pipe(bwd_state_kernel<TB>);
}

// The four launches on `stream`, as the wrapper's plan
// (kernels/mamba2_scan.py::scan_plan) lays them out: hb_state and hb_scan
// heads a block of launches 2 and 4, and the dynamic shared memory of
// launches 1, 2 and 4, which must be the sizes this source uses (else
// cudaErrorInvalidValue, nothing launched). Scratch of the caller: states
// (B, NC, H, N, P), decay (B, NC, H), acum (B, NC, H, LP), ct (B, NC, N,
// LP) and gt (B, NC, L, LP), LP = L rounded up to 4, all f32; s0 (f32) may
// be null (a zero start). Takes 1 <= L <= 128, 4 <= N <= 128 and 4 <= P <=
// 64, N and P multiples of 4, every pointer 16-byte aligned (the wrapper
// checks). Returns the first launch error, or 0.
template <typename TX, typename TB, typename TY>
int scan_forward(const TX* x, const TX* a, const TB* b, const TB* c,
                 const float* s0, TY* y, float* sout, float* states,
                 float* decay, float* acum, float* ct, float* gt, int B,
                 int NC, int L, int H, int P, int N, int hb_state,
                 int hb_scan, int smem_prep, int smem_state, int smem_scan,
                 void* stream) {
  if (smem_prep != kPrepBytes || smem_state != kPipeBytes ||
      smem_scan != kPipeBytes || hb_state < 1 || hb_scan < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int LP = (L + 3) / 4 * 4;
  set_attributes<TX, TB, TY>();
  chunk_prep_kernel<TX, TB>
      <<<dim3((LP + 31) / 32, NC, B), kPrepThreads, kPrepBytes, st>>>(
          a, b, c, acum, decay, ct, gt, NC, L, H, N, LP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_state_kernel<TX, TB>
      <<<dim3((H + hb_state - 1) / hb_state, NC, B), kThreads, kPipeBytes,
         st>>>(x, b, acum, states, NC, L, H, P, N, LP, hb_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(B) * H * N * P / 4;
  state_pass_kernel<<<static_cast<unsigned>((quads + kPassThreads - 1) /
                                            kPassThreads),
                      kPassThreads, 0, st>>>(states, decay, s0, sout, B, NC,
                                             H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_scan_kernel<TX, TY>
      <<<dim3((H + hb_scan - 1) / hb_scan, NC, B), kThreads, kPipeBytes,
         st>>>(x, ct, gt, acum, states, y, NC, L, H, P, N, LP, hb_scan,
               s0 == nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The backward's five launches on `stream`, from what the forward left in
// its scratch: states (B, NC, H, N, P) the carried states, acum, decay and
// gt as scan_forward wrote them, and y its output (f32). dy is y's
// gradient (f32), dfinal the final state's (f32, null: zeros), dinit the
// initial state's (f32, null: not wanted). Scratch of the caller (f32):
// dstates (B, NC, H, N, P), dg (B, NC, H, L, L), dgsum (B, NC, L, L). Out,
// each in its input's type: dx (B, NC, L, H, P), da (B, NC, L, H), db and
// dc (B, NC, L, N). hb_state and smem_state as for the forward's launch 2.
// Returns the first launch error, or 0.
template <typename TB>
int scan_backward(const float* x, const TB* b, const TB* c, const float* y,
                  const float* dy, const float* dfinal, float* dinit,
                  const float* states, const float* acum, const float* decay,
                  const float* gt, float* dstates, float* dg, float* dgsum,
                  float* dx, float* da, TB* db, TB* dc, int B, int NC, int L,
                  int H, int P, int N, int hb_state, int smem_state,
                  void* stream) {
  if (smem_state != kPipeBytes || hb_state < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int LP = (L + 3) / 4 * 4;
  set_attributes<float, TB, float>();
  bwd_state_kernel<TB>
      <<<dim3((H + hb_state - 1) / hb_state, NC, B), kThreads, kPipeBytes,
         st>>>(dy, c, acum, dstates, NC, L, H, P, N, LP, hb_state);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(B) * H * N * P / 4;
  bwd_pass_kernel<<<static_cast<unsigned>((quads + kPassThreads - 1) /
                                          kPassThreads),
                    kPassThreads, 0, st>>>(dstates, decay, dfinal, dinit, B,
                                           NC, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_chunk_kernel<TB><<<dim3(H, NC, B), kGradThreads, 0, st>>>(
      x, dy, y, gt, b, acum, decay, states, dstates, dx, dg, da, NC, L, H, P,
      N, LP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ll = static_cast<size_t>(L) * L;
  const size_t total = static_cast<size_t>(B) * NC * ll;
  bwd_dg_sum_kernel<<<static_cast<unsigned>((total + kPassThreads - 1) /
                                            kPassThreads),
                      kPassThreads, 0, st>>>(dg, dgsum, H, ll, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_bc_kernel<TB><<<dim3(2 * ((L + kRowTile - 1) / kRowTile), NC, B),
                      kGradThreads, 0, st>>>(x, dy, b, c, acum, states,
                                             dstates, dgsum, db, dc, NC, L, H,
                                             P, N, LP);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C launchers (bound with ctypes), one per (xdt and a_dt, b and c,
// y) type that a caller runs, arguments as scan_forward's; then the
// backward's, one per (xdt and a_dt, b and c) type, arguments as
// scan_backward's. The backward reads an f32 y and takes f32 xdt and a_dt,
// as the model gives them (x·dt in f32); a bf16 xdt is forward-only.

// fp32 everywhere
extern "C" int mamba2_scan_f32(
    const float* x, const float* a, const float* b, const float* c,
    const float* s0, float* y, float* sout, float* states, float* decay,
    float* acum, float* ct, float* gt, int B, int NC, int L, int H, int P,
    int N, int hb_state, int hb_scan, int smem_prep, int smem_state,
    int smem_scan, void* stream) {
  return scan_forward(x, a, b, c, s0, y, sout, states, decay, acum, ct, gt, B,
                      NC, L, H, P, N, hb_state, hb_scan, smem_prep,
                      smem_state, smem_scan, stream);
}

// the model's at bf16 compute: f32 xdt and a_dt, bf16 b and c, f32 y
extern "C" int mamba2_scan_f32_bf16bc(
    const float* x, const float* a, const bf16* b, const bf16* c,
    const float* s0, float* y, float* sout, float* states, float* decay,
    float* acum, float* ct, float* gt, int B, int NC, int L, int H, int P,
    int N, int hb_state, int hb_scan, int smem_prep, int smem_state,
    int smem_scan, void* stream) {
  return scan_forward(x, a, b, c, s0, y, sout, states, decay, acum, ct, gt, B,
                      NC, L, H, P, N, hb_state, hb_scan, smem_prep,
                      smem_state, smem_scan, stream);
}

// bf16 everywhere: the Pallas kernel's contract
extern "C" int mamba2_scan_bf16(
    const bf16* x, const bf16* a, const bf16* b, const bf16* c,
    const float* s0, bf16* y, float* sout, float* states, float* decay,
    float* acum, float* ct, float* gt, int B, int NC, int L, int H, int P,
    int N, int hb_state, int hb_scan, int smem_prep, int smem_state,
    int smem_scan, void* stream) {
  return scan_forward(x, a, b, c, s0, y, sout, states, decay, acum, ct, gt, B,
                      NC, L, H, P, N, hb_state, hb_scan, smem_prep,
                      smem_state, smem_scan, stream);
}

// fp32 everywhere
extern "C" int mamba2_scan_bwd_f32(
    const float* x, const float* b, const float* c, const float* y,
    const float* dy, const float* dfinal, float* dinit, const float* states,
    const float* acum, const float* decay, const float* gt, float* dstates,
    float* dg, float* dgsum, float* dx, float* da, float* db, float* dc, int B,
    int NC, int L, int H, int P, int N, int hb_state, int smem_state,
    void* stream) {
  return scan_backward(x, b, c, y, dy, dfinal, dinit, states, acum, decay, gt,
                       dstates, dg, dgsum, dx, da, db, dc, B, NC, L, H, P, N,
                       hb_state, smem_state, stream);
}

// f32 xdt and a_dt, bf16 b and c
extern "C" int mamba2_scan_bwd_f32_bf16bc(
    const float* x, const bf16* b, const bf16* c, const float* y,
    const float* dy, const float* dfinal, float* dinit, const float* states,
    const float* acum, const float* decay, const float* gt, float* dstates,
    float* dg, float* dgsum, float* dx, float* da, bf16* db, bf16* dc, int B,
    int NC, int L, int H, int P, int N, int hb_state, int smem_state,
    void* stream) {
  return scan_backward(x, b, c, y, dy, dfinal, dinit, states, acum, decay, gt,
                       dstates, dg, dgsum, dx, da, db, dc, B, NC, L, H, P, N,
                       hb_state, smem_state, stream);
}

// The blocks an SM the runtime grants each launch at its block size and
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), on the
// current device, into blocks[0..3]: chunk_prep, chunk_state, state_pass,
// chunk_scan (the fp32 kernels). Returns the first error, or 0.
extern "C" int mamba2_scan_occupancy(int* blocks) {
  set_attributes<float, float, float>();
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, chunk_prep_kernel<float, float>, kPrepThreads, kPrepBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 1, chunk_state_kernel<float, float>, kThreads, kPipeBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 2, state_pass_kernel, kPassThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 3, chunk_scan_kernel<float, float>, kThreads, kPipeBytes);
  return static_cast<int>(err);
}
