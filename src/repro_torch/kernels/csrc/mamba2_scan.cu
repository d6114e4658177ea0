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
//
// Design. The TPU grid walks (B, H, NC) with the chunk innermost and
// carries the state in VMEM across grid steps. Blocks on the card run in
// no order, and one block per (batch, head) walking the chunks leaves most
// SMs idle at batch 1 (64 blocks at mamba2-1.3b's 64 heads). So the work
// is split the way ssd_chunked splits it, into three launches on the
// caller's stream:
//   1. chunk_state: a grid over (head group, chunk, batch) forms each
//      chunk's own end state from a zero start, (B ⊙ w)ᵀ X with
//      w = exp(acum_L − acum), into a scratch (B, NC, H, N, P), and the
//      chunk's decay exp(acum_L) into (B, NC, H).
//   2. state_pass: one thread per 4 state elements walks the chunks in
//      order, overwriting each chunk's own state with the state carried
//      into it and writing the final state; it issues 8 chunks' loads
//      before their stores, so that enough bytes are in flight to stream
//      the scratch at the memory's rate.
//   3. chunk_scan: a grid over (head group, chunk, batch) computes y.
// Blocks of 1 and 3 take HB = 8 heads, which share the chunk's B and C: in
// 3 the block forms G = C Bᵀ (L × L) once, then per head adds
// exp(acum_i) · C · stateᵀ and the masked, decayed G times X. The decay
// exp(acum_i − acum_j) is formed once per (i, j) and head, for 32 keys at
// a time, into a shared tile that the whole block then reads. Shared
// memory of 3 at L = N = 128, P = 64: C 66 KB, G 66 KB, a 68 KB region
// that holds B while G is formed and then X and the carried state, the
// decay tile 18 KB: 219 KB of the 227 KB a block may take (1 block an SM).
// Tiles arrive by cp.async, all of a thread's copies in flight at once;
// rows are padded by 4 floats so the float4 reads of a quarter-warp hit
// distinct banks. Tiles are zero-filled past L, N and P, so any L of 1 to
// 128 works. Register tiles: 8 × 8 for G, 8 rows × 4 columns of y a thread
// (the causal mask skips a warp's key tiles above its rows), 4 × 8 of the
// chunk state. Offsets are 64-bit. Every output is a fixed FMA chain, the
// same on every run.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int LT = 128;        // most steps a chunk may have
constexpr int NT = 128;        // widest state (N)
constexpr int PT = 64;         // widest head (P)
constexpr int JT = 32;         // keys per decay tile
constexpr int HB = 8;          // heads per block of launches 1 and 3
constexpr int CSTR = NT + 4;   // row stride of the B and C tiles
constexpr int GSTR = LT + 4;   // of G
constexpr int XSTR = PT + 4;   // of X and of the state tile (N rows)
constexpr int MSTR = JT + 4;   // of the decay tile

// launch 1: B [LT][CSTR] | X [LT][XSTR] | acum [LT]
constexpr int kStateFloats = LT * CSTR + LT * XSTR + LT;
// launch 3: C [LT][CSTR] | G [LT][GSTR] | R | M [LT][MSTR] | acum [LT],
// R = B [LT][CSTR] while G is formed, then X [LT][XSTR] | S [NT][XSTR]
constexpr int kRFloats =
    LT * CSTR > (LT + NT) * XSTR ? LT * CSTR : (LT + NT) * XSTR;
constexpr int kScanFloats =
    LT * CSTR + LT * GSTR + kRFloats + LT * MSTR + LT;
static_assert(kScanFloats * 4 <= 232448, "launch 3 exceeds shared memory");

// rows [0, nrows) x floats [0, width) of dst (row stride ds) from src (row
// stride gs floats), zero past `rows` rows or `cols` floats; width and cols
// are multiples of 4, src 16-byte aligned. The copies are cp.async, all of
// a thread's in flight at once: the caller waits (copies_done) before its
// barrier.
__device__ inline void load_tile(float* dst, int ds, const float* src,
                                 size_t gs, int rows, int cols, int width,
                                 int nrows) {
  const int w4 = width / 4;
  for (int e = threadIdx.x; e < nrows * w4; e += kThreads) {
    const int r = e / w4, c = (e % w4) * 4;
    float* d = dst + r * ds + c;
    if (r < rows && c < cols) {
      const unsigned sd =
          static_cast<unsigned>(__cvta_generic_to_shared(d));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd),
                   "l"(src + r * gs + c));
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void copies_done() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// one warp: acum[l] = a[0] + ... + a[l] (a's steps `as` floats apart) for
// l < L, and acum[L - 1] past L: lane-local runs of 4, then a shuffle scan
// of the lane totals
__device__ inline void chunk_cumsum(float* acum, const float* a, size_t as,
                                    int L) {
  const int lane = threadIdx.x & 31;
  float v[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = lane * 4 + k;
    run += l < L ? a[l * as] : 0.f;
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
  for (int k = 0; k < 4; ++k) acum[lane * 4 + k] = excl + v[k];
}

// launch 1: states[b, c, h] (N x P, zero start) and decay[b, c, h]
__global__ void __launch_bounds__(kThreads, 2)
chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ bm, float* __restrict__ states,
                   float* __restrict__ decay, int NC, int L, int H, int P,
                   int N) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;              // [LT][CSTR]
  float* xs = bs + LT * CSTR;    // [LT][XSTR], rows scaled by their weight
  float* acum = xs + LT * XSTR;  // [LT]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bc = static_cast<size_t>(blockIdx.z) * NC + blockIdx.y;
  const int h0 = blockIdx.x * HB, h1 = min(h0 + HB, H);
  const size_t xrow = static_cast<size_t>(H) * P;

  load_tile(bs, CSTR, bm + bc * L * N, N, L, N, NT, LT);
  for (int h = h0; h < h1; ++h) {
    load_tile(xs, XSTR, x + (bc * L * H + h) * P, xrow, L, P, PT, LT);
    if (tid < 32) chunk_cumsum(acum, a + bc * L * H + h, H, L);
    copies_done();
    __syncthreads();
    const float last = acum[L - 1];
    if (tid == 0) decay[bc * H + h] = expf(last);
    // weight row j of X by exp(acum_L − acum_j) in place
    for (int e = tid; e < L * (PT / 4); e += kThreads) {
      const int r = e / (PT / 4), c = (e % (PT / 4)) * 4;
      float4* v = reinterpret_cast<float4*>(xs + r * XSTR + c);
      const float w = expf(last - acum[r]);
      v->x *= w;
      v->y *= w;
      v->z *= w;
      v->w *= w;
    }
    __syncthreads();
    // thread: p = 4ty + 0..3, n = 4tx + 0..3 and 64 + 4tx + 0..3
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + j * XSTR + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + j * CSTR + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + j * CSTR + 64 + 4 * tx);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float bn[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(xr[r], bn[s], acc[r][s]);
    }
    float* sg = states + (bc * H + h) * static_cast<size_t>(N) * P;
    if (4 * ty < P) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int n = (s < 4 ? 0 : 64) + 4 * tx + (s & 3);
        if (n < N)
          *reinterpret_cast<float4*>(sg + static_cast<size_t>(n) * P +
                                     4 * ty) =
              make_float4(acc[0][s], acc[1][s], acc[2][s], acc[3][s]);
      }
    }
    __syncthreads();  // the next head overwrites xs and acum
  }
}

// launch 2: per 4 state elements (one n, 4 consecutive p), the chunks in
// order, kPass at a time: their loads are all issued before the first
// store, so a thread keeps kPass 16-byte loads in flight; each chunk's own
// state is replaced by the state carried into it
constexpr int kPass = 8;

__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                  const float* __restrict__ s0, float* __restrict__ sout,
                  int B, int NC, int H, int P, int N) {
  const size_t np = static_cast<size_t>(N) * P;
  const size_t e =
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
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
  for (int c0 = 0; c0 < NC; c0 += kPass) {
    float4 own[kPass];
    float d[kPass];
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      if (c0 + i < NC) {
        own[i] = *reinterpret_cast<const float4*>(base + (c0 + i) * cs);
        d[i] = dec[(c0 + i) * H];
      }
    }
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      if (c0 + i < NC) {
        *reinterpret_cast<float4*>(base + (c0 + i) * cs) =
            make_float4(s[0], s[1], s[2], s[3]);
        s[0] = s[0] * d[i] + own[i].x;
        s[1] = s[1] * d[i] + own[i].y;
        s[2] = s[2] * d[i] + own[i].z;
        s[3] = s[3] * d[i] + own[i].w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sout[pn + i * N] = s[i];
}

// launch 3: y for one chunk and HB heads
__global__ void __launch_bounds__(kThreads, 1)
chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ prev, float* __restrict__ y,
                  int NC, int L, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;              // [LT][CSTR]
  float* gs = cs + LT * CSTR;    // [LT][GSTR]
  float* rs = gs + LT * GSTR;    // B, then X and S
  float* ms = rs + kRFloats;     // [LT][MSTR]
  float* acum = ms + LT * MSTR;  // [LT]
  float* bs = rs;                // [LT][CSTR]
  float* xs = rs;                // [LT][XSTR]
  float* ss = rs + LT * XSTR;    // [NT][XSTR]: the carried state, n-major
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bc = static_cast<size_t>(blockIdx.z) * NC + blockIdx.y;
  const int h0 = blockIdx.x * HB, h1 = min(h0 + HB, H);

  load_tile(cs, CSTR, cm + bc * L * N, N, L, N, NT, LT);
  load_tile(bs, CSTR, bm + bc * L * N, N, L, N, NT, LT);
  copies_done();
  __syncthreads();
  {  // G = C Bᵀ: rows ty + 16r, columns tx + 16s
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
    for (int n = 0; n < N; n += 4) {
      float4 cv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        cv[r] = *reinterpret_cast<const float4*>(cs + (ty + 16 * r) * CSTR + n);
#pragma unroll
      for (int s = 0; s < 8; ++s)
        bv[s] = *reinterpret_cast<const float4*>(bs + (tx + 16 * s) * CSTR + n);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          float t = fmaf(cv[r].x, bv[s].x, acc[r][s]);
          t = fmaf(cv[r].y, bv[s].y, t);
          t = fmaf(cv[r].z, bv[s].z, t);
          acc[r][s] = fmaf(cv[r].w, bv[s].w, t);
        }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s)
        gs[(ty + 16 * r) * GSTR + tx + 16 * s] = acc[r][s];
  }
  __syncthreads();  // G is whole; the B tile is free

  const int r0 = 8 * ty;  // this thread's rows r0 .. r0 + 7
  const int p0 = 4 * tx;  // its columns p0 .. p0 + 3
  const bool live = r0 < L && p0 < P;
  const size_t xrow = static_cast<size_t>(H) * P;
  for (int h = h0; h < h1; ++h) {
    if (tid < 32) chunk_cumsum(acum, a + bc * L * H + h, H, L);
    load_tile(xs, XSTR, x + (bc * L * H + h) * P, xrow, L, P, PT, LT);
    load_tile(ss, XSTR, prev + (bc * H + h) * static_cast<size_t>(N) * P, P,
              N, P, PT, NT);
    copies_done();
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    if (live) {  // the carried-in state: exp(acum_i) · C_i · stateᵀ
      for (int n = 0; n < N; n += 4) {
        float4 cv[8], sv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          cv[r] = *reinterpret_cast<const float4*>(cs + (r0 + r) * CSTR + n);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sv[k] = *reinterpret_cast<const float4*>(ss + (n + k) * XSTR + p0);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float c4[4] = {cv[r].x, cv[r].y, cv[r].z, cv[r].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[r][0] = fmaf(c4[k], sv[k].x, acc[r][0]);
            acc[r][1] = fmaf(c4[k], sv[k].y, acc[r][1]);
            acc[r][2] = fmaf(c4[k], sv[k].z, acc[r][2]);
            acc[r][3] = fmaf(c4[k], sv[k].w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float e = expf(acum[r0 + r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }
    }
    // the chunk's own inputs, JT keys at a time: M = G ⊙ exp(acum_i −
    // acum_j) for j <= i, else 0, formed for rows i in [j0, L) (rows above
    // j0 see none of these keys), then y += M X
    for (int j0 = 0; j0 < L; j0 += JT) {
      for (int e = tid; e < (L - j0) * JT; e += kThreads) {
        const int i = j0 + e / JT, jj = e % JT, j = j0 + jj;
        ms[i * MSTR + jj] =
            j <= i ? gs[i * GSTR + j] * expf(acum[i] - acum[j]) : 0.f;
      }
      __syncthreads();
      if (live && r0 + 7 >= j0) {  // j0 and r0 are multiples of 8
        const int jn = min(JT, L - j0);
        for (int jj = 0; jj < jn; jj += 4) {
          float4 mv[8], xv[4];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            mv[r] = *reinterpret_cast<const float4*>(ms + (r0 + r) * MSTR + jj);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            xv[k] = *reinterpret_cast<const float4*>(
                xs + (j0 + jj + k) * XSTR + p0);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float m4[4] = {mv[r].x, mv[r].y, mv[r].z, mv[r].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[r][0] = fmaf(m4[k], xv[k].x, acc[r][0]);
              acc[r][1] = fmaf(m4[k], xv[k].y, acc[r][1]);
              acc[r][2] = fmaf(m4[k], xv[k].z, acc[r][2]);
              acc[r][3] = fmaf(m4[k], xv[k].w, acc[r][3]);
            }
          }
        }
      }
      __syncthreads();  // the next tile overwrites ms
    }
    if (p0 < P) {
      float* yg = y + bc * L * xrow + static_cast<size_t>(h) * P + p0;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r0 + r < L)
          *reinterpret_cast<float4*>(yg + (r0 + r) * xrow) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    // the next head's loads follow the last tile's barrier: nothing reads
    // xs, ss or acum after it
  }
}

}  // namespace

// The three launches on `stream`; states (B, NC, H, N, P) and decay
// (B, NC, H) are the caller's scratch, s0 may be null (a zero start).
// Takes 1 <= L <= 128, 4 <= N <= 128 and 4 <= P <= 64, N and P multiples
// of 4, every pointer 16-byte aligned (the wrapper checks). Returns the
// first launch error, or 0.
extern "C" int mamba2_scan_f32(const float* x, const float* a, const float* b,
                               const float* c, const float* s0, float* y,
                               float* sout, float* states, float* decay,
                               int B, int NC, int L, int H, int P, int N,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int state_bytes = kStateFloats * 4, scan_bytes = kScanFloats * 4;
  cudaFuncSetAttribute(chunk_state_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       state_bytes);
  cudaFuncSetAttribute(chunk_scan_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       scan_bytes);
  const dim3 grid((H + HB - 1) / HB, NC, B);
  chunk_state_kernel<<<grid, kThreads, state_bytes, st>>>(x, a, b, states,
                                                          decay, NC, L, H,
                                                          P, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(B) * H * N * P / 4;
  state_pass_kernel<<<static_cast<unsigned>((quads + kThreads - 1) /
                                            kThreads),
                      kThreads, 0, st>>>(states, decay, s0, sout, B, NC, H,
                                         P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_scan_kernel<<<grid, kThreads, scan_bytes, st>>>(x, a, b, c, states, y,
                                                        NC, L, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
