// Mamba2 SSD chunk scan, fp32, for Hopper (sm_90a).
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
// Where it runs: every Mamba2 block's prefill
// (models/mamba2.py::mamba_seq → ssd_chunked → ops.mamba_chunk_scan_op);
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
#include <cstdint>

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

// ---------------------------------------------------------------------------
// launch 1: acum, decay, Cᵀ and the causal tiles of Gᵀ

__global__ void __launch_bounds__(kPrepThreads)
chunk_prep_kernel(const float* __restrict__ a, const float* __restrict__ bm,
                  const float* __restrict__ cm, float* __restrict__ acum,
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
      cp16(d, cm + (bc * L + i) * N + 4 * c4);
    else
      zero4(d);
  }
  for (int e = tid; e < jmax * (NT / 4); e += kPrepThreads) {
    const int j = e >> 5, c4 = e & 31;
    if (4 * c4 < N) cp16(bs + j * CSTR + 4 * c4, bm + (bc * L + j) * N + 4 * c4);
  }
  commit();

  // acum of heads q·8 + warp, every 8·gridDim.x: lane-local runs of 4, then
  // a shuffle scan of the lane totals; past L it stays at acum_{L-1}
  for (int h = q * 8 + warp; h < H; h += 8 * gridDim.x) {
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = lane * 4 + k;
      run += l < L ? a[(bc * L + l) * H + h] : 0.f;
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
// below P of a row-major output whose rows are `stride` floats apart
__device__ __forceinline__ void store_tile(const float (&acc)[4][2][8],
                                           float* out, size_t stride,
                                           int rows, int P, int ay, int bx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 32 * r + ay + e;
      if (i >= rows) continue;
      float* o = out + i * stride;
      if (bx < P)
        *reinterpret_cast<float4*>(o + bx) = make_float4(
            acc[r][e][0], acc[r][e][1], acc[r][e][2], acc[r][e][3]);
      if (32 + bx < P)
        *reinterpret_cast<float4*>(o + 32 + bx) = make_float4(
            acc[r][e][4], acc[r][e][5], acc[r][e][6], acc[r][e][7]);
    }
}

// copy acum of head h (LP floats) into a slot; the caller commits
__device__ __forceinline__ void load_acum(float* slot, const float* acum,
                                          size_t bc, int H, int h, int LP) {
  if (static_cast<int>(threadIdx.x) < LP / 4)
    cp16(slot + 4 * threadIdx.x, acum + (bc * H + h) * LP + 4 * threadIdx.x);
}

// launch 2: states[b, c, h] (N x P, zero start) for HB heads
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                   const float* __restrict__ acum, float* __restrict__ states,
                   int NC, int L, int H, int P, int N, int LP, int HB) {
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
        cp16(d, bm + (bc * L + j) * N + 4 * c4);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // X[j][p]
      const int k = (tid >> 4) + 8 * q, c4 = tid & 15, j = j0 + k;
      float* d = bs + k * PT + 4 * c4;
      if (j >= L)
        zero4(d);
      else if (4 * c4 < P)
        cp16(d, x + (bc * L + j) * xrow + static_cast<size_t>(h0 + hh) * P +
                    4 * c4);
    }
    if (u == ns - 1 && hh + 1 < nh)
      load_acum(slots + ((hh + 1) % kAcumSlots) * LT, acum, bc, H, h0 + hh + 1,
                LP);
  };
  // w_j = exp(acum_L − acum_j) on the rows of X this thread copied
  auto weigh = [&](int buf, int hh, int u) {
    float* bs = smem + buf * kStageFloats + kAFloats;
    const int j0 = u * KS;
    const float* ac = slots + (hh % kAcumSlots) * LT;
    const float last = ac[L - 1];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = (tid >> 4) + 8 * q, c4 = tid & 15, j = j0 + k;
      if (j < L && 4 * c4 < P) {
        float4* v = reinterpret_cast<float4*>(bs + k * PT + 4 * c4);
        const float w = __expf(last - ac[j]);
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

// launch 3: per 4 state elements (one n, 4 consecutive p), the chunks in
// order, each chunk's own state replaced by the state carried into it. A
// thread keeps kPass chunks' 16-byte loads in flight all the way: the
// load of chunk c + kPass starts as soon as chunk c's is consumed, in
// the register chunk c freed (the loop is unrolled kPass chunks at a time
// so that the ring's registers have fixed names)
constexpr int kPass = 16;

__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                  const float* __restrict__ s0, float* __restrict__ sout,
                  int B, int NC, int H, int P, int N) {
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
  float4 own[kPass];
  float d[kPass];
#pragma unroll
  for (int i = 0; i < kPass; ++i) {
    if (i < NC) {
      own[i] = *reinterpret_cast<const float4*>(base + i * cs);
      d[i] = dec[static_cast<size_t>(i) * H];
    }
  }
  for (int c0 = 0; c0 < NC; c0 += kPass) {
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      const int c = c0 + i;
      if (c < NC) {
        *reinterpret_cast<float4*>(base + c * cs) =
            make_float4(s[0], s[1], s[2], s[3]);
        s[0] = s[0] * d[i] + own[i].x;
        s[1] = s[1] * d[i] + own[i].y;
        s[2] = s[2] * d[i] + own[i].z;
        s[3] = s[3] * d[i] + own[i].w;
        if (c + kPass < NC) {
          own[i] = *reinterpret_cast<const float4*>(base + (c + kPass) * cs);
          d[i] = dec[static_cast<size_t>(c + kPass) * H];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sout[pn + i * N] = s[i];
}

// launch 4: y for one chunk and HB heads. zero_start: no initial state, so
// chunk 0 carries none in and skips C · state
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ ct,
                  const float* __restrict__ gt, const float* __restrict__ acum,
                  const float* __restrict__ prev, float* __restrict__ y,
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
          cp16(d, x + (bc * L + j) * xrow + static_cast<size_t>(h) * P +
                      4 * c4);
      }
    }
    if (u == tph - 1 && hh + 1 < nh)
      load_acum(slots + ((hh + 1) % kAcumSlots) * LT, acum, bc, H, h + 1, LP);
  };
  // M = Gᵀ ⊙ exp(acum_i − acum_j) for i >= j, else 0, on the entries of a
  // key slab this thread copied
  auto decay_mask = [&](int buf, int hh, int u) {
    if (u < nst) return;
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

void set_attributes() {
  cudaFuncSetAttribute(chunk_prep_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kPrepBytes);
  cudaFuncSetAttribute(chunk_state_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kPipeBytes);
  cudaFuncSetAttribute(chunk_scan_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kPipeBytes);
  cudaFuncSetAttribute(chunk_state_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaFuncSetAttribute(chunk_scan_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// The four launches on `stream`, as the wrapper's plan
// (kernels/mamba2_scan.py::scan_plan) lays them out: hb_state and hb_scan
// heads a block of launches 2 and 4, and the dynamic shared memory of
// launches 1, 2 and 4, which must be the sizes this source uses (else
// cudaErrorInvalidValue, nothing launched). Scratch of the caller: states
// (B, NC, H, N, P), decay (B, NC, H), acum (B, NC, H, LP), ct (B, NC, N,
// LP) and gt (B, NC, L, LP), LP = L rounded up to 4; s0 may be null (a
// zero start). Takes 1 <= L <= 128, 4 <= N <= 128 and 4 <= P <= 64, N and
// P multiples of 4, every pointer 16-byte aligned (the wrapper checks).
// Returns the first launch error, or 0.
extern "C" int mamba2_scan_f32(const float* x, const float* a, const float* b,
                               const float* c, const float* s0, float* y,
                               float* sout, float* states, float* decay,
                               float* acum, float* ct, float* gt, int B,
                               int NC, int L, int H, int P, int N,
                               int hb_state, int hb_scan, int smem_prep,
                               int smem_state, int smem_scan, void* stream) {
  if (smem_prep != kPrepBytes || smem_state != kPipeBytes ||
      smem_scan != kPipeBytes || hb_state < 1 || hb_scan < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int LP = (L + 3) / 4 * 4;
  set_attributes();
  chunk_prep_kernel<<<dim3((LP + 31) / 32, NC, B), kPrepThreads, kPrepBytes,
                      st>>>(a, b, c, acum, decay, ct, gt, NC, L, H, N, LP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_state_kernel<<<dim3((H + hb_state - 1) / hb_state, NC, B), kThreads,
                       kPipeBytes, st>>>(x, b, acum, states, NC, L, H, P, N,
                                         LP, hb_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(B) * H * N * P / 4;
  state_pass_kernel<<<static_cast<unsigned>((quads + kPassThreads - 1) /
                                            kPassThreads),
                      kPassThreads, 0, st>>>(states, decay, s0, sout, B, NC,
                                             H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_scan_kernel<<<dim3((H + hb_scan - 1) / hb_scan, NC, B), kThreads,
                      kPipeBytes, st>>>(x, ct, gt, acum, states, y, NC, L, H,
                                        P, N, LP, hb_scan, s0 == nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The blocks an SM the runtime grants each launch at its block size and
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), on the
// current device, into blocks[0..3]: chunk_prep, chunk_state, state_pass,
// chunk_scan. Returns the first error, or 0.
extern "C" int mamba2_scan_occupancy(int* blocks) {
  set_attributes();
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, chunk_prep_kernel, kPrepThreads, kPrepBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 1, chunk_state_kernel, kThreads, kPipeBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 2, state_pass_kernel, kPassThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 3, chunk_scan_kernel, kThreads, kPipeBytes);
  return static_cast<int>(err);
}
