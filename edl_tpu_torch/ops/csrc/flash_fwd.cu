// Causal / full GQA flash-attention forward for Hopper (sm_90a), bf16.
//
// Replaces edl_tpu/ops/flash_attention.py::_flash_kernel on both of its
// paths: the primal, no-gradient one (with_lse=False, entry
// flash_fwd_bf16), which every serving prefill runs when
// LlamaConfig.use_flash is set, and the training one (with_lse=True,
// _flash_fwd, entry flash_fwd_lse_bf16), which also writes the per-row
// base-2 logsumexp the backward kernels (flash_bwd.cu) consume.
//
// What it computes is _flash_kernel's function, not its grid:
//   s = (q . k^T) * sm_scale * log2(e)         f32 accumulation
//   causal mask rows >= cols (NEG_INF = -1e30), only on tiles that
//   cross the diagonal or the ragged T edge; tiles above the diagonal
//   are never loaded
//   base-2 online softmax: m_new = max(m, rowmax(s)), p = exp2(s - m_new),
//   alpha = exp2(m - m_new), l = l*alpha + rowsum(p) (p in f32),
//   acc = acc*alpha + bf16(p) . v                f32 accumulation
//   out = bf16(acc / max(l, 1e-20))
//   with lse: lse = m + log2(max(l, 1e-20)), f32, one value per valid
//   row in a compact [B*H, T] array (the TPU kernel's lane-replicated
//   [.., 128] layout was a Mosaic constraint; rows past T are not
//   written)
// Query head h reads KV head h / (H / KV); K/V are never repeated.
//
// Bound on an H100 SXM: the larger of FLOPs / 989 TF/s (bf16 tensor
// cores) and bytes / 3.35 TB/s (q, k, v read once, out and lse written
// once). At the serving and training shapes (d = 128, T >= 128) it is
// bound by operations.
//
// Design, simple by intent: one thread block of 4 warps per
// (b*h, 64-query tile); the Q tile is staged through shared memory into
// registers, then a loop inside the block walks 64-key K/V tiles up to
// the causal limit. Each warp owns 16 query rows and runs both products
// on mma.sync m16n8k16 (bf16 in, f32 accumulate); the S accumulator is
// re-packed in registers as the A operand of P.V. The lse costs one
// log2 and one f32 store per row at the end. No cp.async, no
// pipelining, no wgmma/TMA: those are left to a later change that makes
// the kernel fast. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through the plain C entry points (ctypes). The kernel
// allocates nothing and does not synchronise; it launches on the stream
// it is given.

#include "mma_bf16.cuh"

namespace {

using namespace edl;
constexpr int kBQ = kTile;  // query rows per block
constexpr int kBK = kTile;  // keys per K/V tile

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // [B*H, T] compact, written only by the kWithLse variant
  int T, H, groups;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  float scale;  // sm_scale * log2(e)
};

template <int D, bool kCausal, bool kWithLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Args p) {
  constexpr int LD = D + 8;  // padded row: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * LD;
  __nv_bfloat16* sV = sK + kBK * LD;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / p.groups;
  const int q0 = qt * kBQ;
  const int T = p.T;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_st;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + kvh * p.v_sh;

  load_tile<D, LD>(sQ, qg, p.q_st, min(kBQ, T - q0));
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  // Q fragments (A operand, 16 rows x D) stay in registers
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    mma_a_from_smem<LD>(qf[kc], sQ + (warp * 16) * LD, kc * 16, g, t);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8

  int n_tiles = (T + kBK - 1) / kBK;
  if (kCausal) n_tiles = min(n_tiles, qt + 1);  // k0 <= q0 + 63

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile is no longer read
    load_tile<D, LD>(sK, kg + k0 * p.k_st, p.k_st, min(kBK, T - k0));
    load_tile<D, LD>(sV, vg + k0 * p.v_st, p.v_st, min(kBK, T - k0));
    __syncthreads();

    // S = Q . K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t b0, b1;
        mma_b_nmajor<LD>(b0, b1, sK + (nt * 8) * LD + kc * 16, g, t);
        mma_bf16(s[nt], qf[kc], b0, b1);
      }
    }

    const bool need_mask =
        (kCausal && k0 + kBK - 1 > q0) || (k0 + kBK > T);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (need_mask) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = row0 + ((e >> 1) << 3);
          if (col >= T || (kCausal && col > row)) x = kNegInf;
        }
        s[nt][e] = x;
      }
    }

    // online softmax, base 2; rows r = 0 (row0) and r = 1 (row0 + 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = exp2f(s[nt][2 * r] - m_new);
        const float p1 = exp2f(s[nt][2 * r + 1] - m_new);
        s[nt][2 * r] = p0;
        s[nt][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    // acc += bf16(P) . V -- P never leaves registers
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t a[4];
      mma_a_from_acc(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        mma_b_kmajor<LD>(b0, b1, sV + (kc * 16) * LD + dt * 8, g, t);
        mma_bf16(acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    const float l = fmaxf(l_run[r], 1e-20f);
    __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_st;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const uint32_t w = pack_f32(acc[dt][2 * r] / l, acc[dt][2 * r + 1] / l);
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) = w;
    }
    // the four threads of a row group hold the same m and l: one writes
    if (kWithLse && t == 0) {
      p.lse[static_cast<long long>(bh) * T + row] = m_run[r] + log2f(l);
    }
  }
}

template <int D, bool kCausal, bool kWithLse>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const int smem = (kBQ + 2 * kBK) * LD * int(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kCausal, kWithLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + kBQ - 1) / kBQ, B * a.H);
  flash_fwd_kernel<D, kCausal, kWithLse><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kWithLse>
int dispatch(const Args& a, int B, int D, int causal, cudaStream_t st) {
  cudaError_t err;
  if (D == 64) {
    err = causal ? launch<64, true, kWithLse>(a, B, st)
                 : launch<64, false, kWithLse>(a, B, st);
  } else if (D == 128) {
    err = causal ? launch<128, true, kWithLse>(a, B, st)
                 : launch<128, false, kWithLse>(a, B, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}

bool fill(Args& a, const void* q, const void* k, const void* v, void* o,
          float* lse, int B, int T, int H, int KV, const long long* s,
          float scale) {
  if (T < 1 || B < 1 || KV < 1 || H % KV != 0) return false;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  a.T = T;
  a.H = H;
  a.groups = H / KV;
  a.q_sb = s[0]; a.q_st = s[1]; a.q_sh = s[2];
  a.k_sb = s[3]; a.k_st = s[4]; a.k_sh = s[5];
  a.v_sb = s[6]; a.v_st = s[7]; a.v_sh = s[8];
  a.o_sb = s[9]; a.o_st = s[10]; a.o_sh = s[11];
  a.scale = scale;
  return true;
}

}  // namespace

// q [B,T,H,D], k/v [B,T,KV,D], o [B,T,H,D]; strides in elements, the
// last dimension contiguous, every row 16-byte aligned (the wrapper
// checks). Returns the CUDA error of the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, int B, int T, int H, int KV, int D,
                              long long q_sb, long long q_st, long long q_sh,
                              long long k_sb, long long k_st, long long k_sh,
                              long long v_sb, long long v_st, long long v_sh,
                              long long o_sb, long long o_st, long long o_sh,
                              float scale, int causal, void* stream) {
  const long long s[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                           v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  Args a;
  if (!fill(a, q, k, v, o, nullptr, B, T, H, KV, s, scale)) {
    return int(cudaErrorInvalidValue);
  }
  return dispatch<false>(a, B, D, causal,
                         static_cast<cudaStream_t>(stream));
}

// As flash_fwd_bf16, plus lse: f32 [B*H, T] contiguous (row b*H + h).
extern "C" int flash_fwd_lse_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int T, int H, int KV, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, float scale, int causal, void* stream) {
  const long long s[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                           v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  Args a;
  if (lse == nullptr ||
      !fill(a, q, k, v, o, static_cast<float*>(lse), B, T, H, KV, s, scale)) {
    return int(cudaErrorInvalidValue);
  }
  return dispatch<true>(a, B, D, causal, static_cast<cudaStream_t>(stream));
}
