// Exact sequential scan of one feature block through a linear learner's
// closed-form rule — the CUDA counterpart of the Pallas kernel
// hivemall_tpu/kernels/linear_scan.py::_make_kernel (called through
// pallas_scan_raw). Built for sm_90a with nvcc, bound with ctypes
// (hivemall_tpu_torch/kernels/linear_scan.py holds the wrapper and the plain
// torch version this kernel is tested against).
//
// What it computes, per row b of the block, in row order:
//   - Welford pre_row on the running target statistics (rules that keep them);
//   - gather the K lanes of w / cov / slots (dead lanes — idx outside
//     [0, D) — read 0, cov reads 1.0) and form score = sum(w*x),
//     sq_norm = sum(x*x), variance = sum(cov*x*x);
//   - the rule's closed form (a __device__ branch per rule id);
//   - apply: every table gathers ALL lanes before any lane writes; lane
//     deltas add up where lanes repeat a feature, in lane order, and a
//     derive_w rule sets w with the last repeating lane winning — the Pallas
//     kernel's lane_add / lane_set order;
//   - the row's loss.
// t = step0 + b + 1 as float, the rule's example counter.
//
// Design. Row b+1 reads what row b wrote, so rows are sequential and the
// block runs as ONE CTA of ONE warp. Thread `lane` owns lanes k = lane,
// lane+32, ... (any K). Row scalars are butterfly warp-shuffle sums, so
// every thread holds them. The row's lanes and their deltas sit in shared
// memory; for each feature the first lane holding it (its "leader") sums the
// deltas of all lanes holding it, in lane order, and writes the table once:
// no atomics, no write races, and the result is deterministic. __syncwarp()
// separates the gather, the apply and the next row; the warp's memory
// ordering makes row b's writes visible to row b+1's reads. Tables live in
// device memory and are updated IN PLACE (the Pallas kernel aliases its
// tables in->out the same way).
//
// What bounds it on an H100: latency, not bytes. Each row is a dependent
// chain — load idx/val, gather the tables at those ids, reduce, scan the
// lanes, write — and the next row cannot start its gather before this row's
// write. w+cov at 2^22 dims is 32 MB, within the 50 MB L2, so the gathers
// mostly hit L2 and the chain is a few memory round trips per row, while
// the bytes per row (~0.8 KB at K=32) would take ~0.25 ns at 3.35 TB/s.
// row_chain_floor_kernel below runs that chain alone; chip_smoke.py times
// it beside the scan as the scan's latency floor.
// What a later version could do about it: prefetch row b+1's idx/val with
// cp.async while row b computes (takes one round trip off the chain), pin
// the tables in L2 with a persisting access-policy window, and run
// independent blocks (other models, replicas) on the other 131 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The kernel's rule forms, one X(ID, "rule name", "hyperparameters in the
// order of h[]") per line; a rule's id is its position. This table is the
// only record of ids and hyperparameter order: the Python wrapper reads it
// from this file (kernels/linear_scan.py::KERNEL_FORMS). Slots are passed
// sorted by name (ADAGRAD_RDA: sum_grad, sum_sqgrad; ADAGRAD_REGR:
// sum_sqgrad; ADADELTA_REGR: sum_sq_dx, sum_sqgrad) and globals too (m2,
// mean, n for PA1A_REGR, PA2A_REGR and AROWE2_REGR).
#define HM_RULE_FORMS(X)                             \
  X(PERCEPTRON, "perceptron", "")                    \
  X(PA, "pa", "")                                    \
  X(PA1, "pa1", "c")                                 \
  X(PA2, "pa2", "c")                                 \
  X(CW, "cw", "phi")                                 \
  X(AROW, "arow", "r")                               \
  X(AROWH, "arowh", "r,c")                           \
  X(SCW1, "scw1", "phi,c")                           \
  X(SCW2, "scw2", "phi,c")                           \
  X(ADAGRAD_RDA, "adagrad_rda", "eta,lambda,scale")  \
  X(ADAGRAD_REGR, "adagrad_regr", "eta,eps,scale")   \
  X(ADADELTA_REGR, "adadelta_regr", "rho,eps,scale") \
  X(PA1_REGR, "pa1_regr", "c,epsilon")               \
  X(PA1A_REGR, "pa1a_regr", "c,epsilon")             \
  X(PA2_REGR, "pa2_regr", "c,epsilon")               \
  X(PA2A_REGR, "pa2a_regr", "c,epsilon")             \
  X(AROW_REGR, "arow_regr", "r")                     \
  X(AROWE_REGR, "arowe_regr", "r,epsilon")           \
  X(AROWE2_REGR, "arowe2_regr", "r,epsilon")

#define HM_RULE_ID(id, name, keys) id,
enum RuleId : int { HM_RULE_FORMS(HM_RULE_ID) N_RULES };
#undef HM_RULE_ID

constexpr int MAX_HYPER = 4;
struct Hyper { float h[MAX_HYPER]; };

__host__ __device__ constexpr bool uses_cov(int r) {
  return r == CW || r == AROW || r == AROWH || r == SCW1 || r == SCW2 ||
         r == AROW_REGR || r == AROWE_REGR || r == AROWE2_REGR;
}
__host__ __device__ constexpr int n_slots(int r) {
  return (r == ADAGRAD_RDA || r == ADADELTA_REGR) ? 2 : (r == ADAGRAD_REGR ? 1 : 0);
}
__host__ __device__ constexpr bool has_globals(int r) {
  return r == PA1A_REGR || r == PA2A_REGR || r == AROWE2_REGR;
}
__host__ __device__ constexpr bool derives_w(int r) { return r == ADAGRAD_RDA; }

constexpr float FLOAT_MAX = 3.4028235e38f;
constexpr unsigned FULL = 0xffffffffu;
// floats of shared memory per lane: idx, val, w, cov, s0, s1, dw, dcov, ds0, ds1
constexpr int SMEM_FLOATS_PER_LANE = 10;
// the most dynamic shared memory one block may have on sm_90
constexpr int SMEM_LIMIT_BYTES = 232448;
constexpr int MAX_K = SMEM_LIMIT_BYTES / (SMEM_FLOATS_PER_LANE * (int)sizeof(float));

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float safe_div(float num, float den) {
  return den == 0.f ? 0.f : num / den;
}

__device__ __forceinline__ float logistic_grad(float y, float p) {
  return p > -100.f ? y - 1.f / (1.f + expf(-p)) : y;
}

__device__ __forceinline__ float stddev(float m2, float n) {
  float var = n > 1.f ? m2 / fmaxf(n - 1.f, 1.f) : 0.f;
  return sqrtf(fmaxf(var, 0.f));
}

// The rule's row-level result: what every lane's delta is a function of.
struct RowOut {
  float loss;
  bool updated;
  float a;  // per-rule coefficient (see lane_deltas)
  float b;  // second coefficient
};

template <int R>
__device__ __forceinline__ RowOut row_rule(const Hyper& hp, float y, float score,
                                           float sq, float var, float m2, float n) {
  RowOut o{0.f, false, 0.f, 0.f};
  const float* h = hp.h;
  if (R == PERCEPTRON) {
    o.updated = y * score <= 0.f;
    o.loss = o.updated ? 1.f : 0.f;
    o.a = y;
  } else if (R == PA || R == PA1 || R == PA2) {
    float loss = fmaxf(0.f, 1.f - y * score);
    float eta;
    if (R == PA) eta = safe_div(loss, sq);
    else if (R == PA1) eta = fminf(h[0], safe_div(loss, sq));
    else eta = loss / (sq + 0.5f / h[0]);
    o.loss = loss;
    o.updated = loss > 0.f;
    o.a = eta * y;
  } else if (R == CW) {
    float phi = h[0];
    float s = score * y;
    float bb = 1.f + 2.f * phi * s;
    float disc = fmaxf(0.f, bb * bb - 8.f * phi * (s - phi * var));
    float gamma = safe_div(-bb + sqrtf(disc), 4.f * phi * var);
    o.updated = gamma > 0.f;
    float alpha = o.updated ? gamma : 0.f;
    o.a = alpha * y;          // dw = a * cov * x
    o.b = 2.f * alpha * phi;  // dcov = cov / (1 + b*x*x*cov) - cov
    o.loss = score * y < 0.f ? 1.f : 0.f;
  } else if (R == AROW || R == AROWH) {
    float m = score * y;
    float alpha_scale;
    if (R == AROWH) {
      o.loss = fmaxf(0.f, h[1] - m);
      o.updated = o.loss > 0.f;
      alpha_scale = o.loss;
    } else {
      o.updated = m < 1.f;
      alpha_scale = 1.f - m;
      o.loss = m < 0.f ? 1.f : 0.f;
    }
    float beta = 1.f / (var + h[0]);
    float alpha = o.updated ? alpha_scale * beta : 0.f;
    o.a = y * alpha;                 // dw = a * cv
    o.b = o.updated ? -beta : 0.f;   // dcov = b * cv * cv
  } else if (R == SCW1 || R == SCW2) {
    float phi = h[0], c = h[1];
    float m = score;
    o.loss = fmaxf(0.f, phi * sqrtf(fmaxf(var, 0.f)) - y * m);
    float sq_phi = phi * phi;
    float alpha;
    if (R == SCW1) {
      float psi = 1.f + sq_phi / 2.f;
      float zeta = 1.f + sq_phi;
      float alpha_numer = -m * psi +
          sqrtf(fmaxf(0.f, (m * m * sq_phi * sq_phi / 4.f) + var * sq_phi * zeta));
      alpha = safe_div(alpha_numer, var * zeta);
      // the reference applies max(c, alpha) (SoftConfideceWeightedUDTF.java:186)
      alpha = alpha <= 0.f ? 0.f : fmaxf(c, alpha);
    } else {
      float nn = var + c / 2.f;
      float v_phi_phi = var * sq_phi;
      float v_phi_phi_m = v_phi_phi * m;
      float term = v_phi_phi_m * m * var + 4.f * nn * var * (nn + v_phi_phi);
      float gamma = phi * sqrtf(fmaxf(0.f, term));
      float alpha_numer = -(2.f * m * nn + v_phi_phi_m) + gamma;
      float alpha_denom = 2.f * (nn * nn + nn * v_phi_phi);
      alpha = alpha_numer <= 0.f ? 0.f : safe_div(alpha_numer, alpha_denom);
    }
    float beta_numer = alpha * phi;
    float var_alpha_phi = var * beta_numer;
    float u = -var_alpha_phi +
        sqrtf(fmaxf(0.f, var_alpha_phi * var_alpha_phi + 4.f * var));
    float beta = safe_div(beta_numer, u / 2.f + var_alpha_phi);
    o.updated = (o.loss > 0.f) && (alpha != 0.f) && (beta != 0.f);
    o.a = y * (o.updated ? alpha : 0.f);  // dw = a * cv
    o.b = -(o.updated ? beta : 0.f);      // dcov = b * cv * cv
  } else if (R == ADAGRAD_RDA) {
    o.loss = fmaxf(0.f, 1.f - y * score);
    o.updated = o.loss > 0.f;
    o.a = -y;  // gradient = a * x
  } else if (R == ADAGRAD_REGR || R == ADADELTA_REGR) {
    float g = logistic_grad(y, score);
    o.loss = g * g;
    o.updated = true;
    o.a = g;
    o.b = g * (g / h[2]);  // g_g
  } else if (R == PA1_REGR || R == PA1A_REGR || R == PA2_REGR || R == PA2A_REGR) {
    float eps = h[1];
    if (R == PA1A_REGR || R == PA2A_REGR) eps = h[1] * stddev(m2, n);
    float loss = fmaxf(0.f, fabsf(y - score) - eps);
    float sign = y - score > 0.f ? 1.f : -1.f;
    float eta;
    if (R == PA1_REGR || R == PA1A_REGR)
      eta = fminf(h[0], sq == 0.f ? FLOAT_MAX : loss / fmaxf(sq, 1e-38f));
    else
      eta = loss / (sq + 0.5f / h[0]);
    float coeff = sign * eta;
    o.loss = loss;
    o.updated = loss > 0.f && isfinite(coeff);
    o.a = coeff;  // dw = a * x
  } else {  // AROW_REGR, AROWE_REGR, AROWE2_REGR
    float beta = 1.f / (var + h[0]);
    float coeff;
    if (R == AROW_REGR) {
      coeff = y - score;
      o.updated = true;
      o.loss = coeff * coeff;
    } else {
      float eps = R == AROWE2_REGR ? h[1] * stddev(m2, n) : h[1];
      float l = fmaxf(0.f, fabsf(y - score) - eps);
      coeff = y - score > 0.f ? l : -l;
      o.updated = l > 0.f;
      o.loss = l;
    }
    o.a = coeff;  // dw = a * cv * b'
    o.b = beta;   // dcov = -b * cv * cv
  }
  return o;
}

// One lane's deltas. For derive_w rules dw carries the lane's new w.
template <int R>
__device__ __forceinline__ void lane_deltas(const Hyper& hp, const RowOut& o, float t,
                                            float x, float w, float cov, float s0,
                                            float s1, float& dw, float& dcov,
                                            float& ds0, float& ds1) {
  const float* h = hp.h;
  dw = 0.f; dcov = 0.f; ds0 = 0.f; ds1 = 0.f;
  if (R == PERCEPTRON || R == PA || R == PA1 || R == PA2 || R == PA1_REGR ||
      R == PA1A_REGR || R == PA2_REGR || R == PA2A_REGR) {
    dw = o.updated ? o.a * x : 0.f;
  } else if (R == CW) {
    dw = o.a * cov * x;
    float denom = 1.f + o.b * x * x * cov;
    dcov = cov / denom - cov;
  } else if (R == AROW || R == AROWH || R == SCW1 || R == SCW2) {
    float cv = cov * x;
    dw = o.a * cv;
    dcov = o.b * cv * cv;
  } else if (R == ADAGRAD_RDA) {
    const float scale = h[2];
    float g = o.updated ? (o.a * x) * scale : 0.f;
    ds0 = g;
    ds1 = g * g;
    if (o.updated) {
      // derive_w on this lane's slots after its own delta
      // (AdaGradRDAUDTF.java:120-141)
      float sum_grad = (s0 + ds0) * scale;
      float sum_sqgrad = (s1 + ds1) * scale;
      float sign = sum_grad > 0.f ? 1.f : -1.f;
      float mog = sign * sum_grad / t - h[1];
      float denom = sqrtf(fmaxf(sum_sqgrad, 1e-30f));
      float wn = -1.f * sign * h[0] * t * mog / denom;
      dw = mog < 0.f ? 0.f : wn;
    } else {
      dw = w;
    }
  } else if (R == ADAGRAD_REGR) {
    float new_sqg = s0 + o.b;
    float eta_t = h[0] / sqrtf(h[1] + new_sqg * h[2]);
    dw = eta_t * o.a * x;
    ds0 = o.b;
  } else if (R == ADADELTA_REGR) {
    const float decay = h[0], eps = h[1], scale = h[2];
    float old_sqdx = s0, old_sqg = s1;
    float new_sqg = decay * old_sqg + (1.f - decay) * o.b;
    float dx = sqrtf((old_sqdx + eps) / (old_sqg * scale + eps)) * o.a;
    float new_sqdx = decay * old_sqdx + (1.f - decay) * dx * dx;
    dw = dx * x;
    ds0 = new_sqdx - old_sqdx;
    ds1 = new_sqg - old_sqg;
  } else {  // AROW regressors
    float cv = cov * x;
    dw = o.updated ? o.a * cv * o.b : 0.f;
    dcov = o.updated ? -o.b * cv * cv : 0.f;
  }
}

template <int R>
__global__ void __launch_bounds__(32)
linear_scan_kernel(Hyper hp, const int32_t* __restrict__ idx,
                   const float* __restrict__ val, const float* __restrict__ yv,
                   float* __restrict__ loss_out, float* w, float* cov, float* s0,
                   float* s1, float* glob, int B, int K, long long D, int step0) {
  constexpr bool COV = uses_cov(R);
  constexpr int NS = n_slots(R);
  constexpr bool GLOB = has_globals(R);
  constexpr bool DERIVE = derives_w(R);

  extern __shared__ float smem[];
  int* s_idx = reinterpret_cast<int*>(smem);  // feature id, -1 on a dead lane
  float* s_val = smem + K;
  float* s_w = smem + 2 * K;
  float* s_cov = smem + 3 * K;
  float* s_s0 = smem + 4 * K;
  float* s_s1 = smem + 5 * K;
  float* s_dw = smem + 6 * K;
  float* s_dcov = smem + 7 * K;
  float* s_ds0 = smem + 8 * K;
  float* s_ds1 = smem + 9 * K;

  const int lane = threadIdx.x;
  // Welford state (globals sorted by name: m2, mean, n), same in every thread
  float g_m2 = 0.f, g_mean = 0.f, g_n = 0.f;
  if (GLOB) { g_m2 = glob[0]; g_mean = glob[1]; g_n = glob[2]; }

  for (int b = 0; b < B; ++b) {
    const float y = yv[b];
    const float t = (float)(step0 + b + 1);
    if (GLOB) {
      float n1 = g_n + 1.f;
      float delta = y - g_mean;
      float mean1 = g_mean + delta / n1;
      g_m2 = g_m2 + delta * (y - mean1);
      g_mean = mean1;
      g_n = n1;
    }

    // gather: every lane reads before any lane writes
    float score = 0.f, sq = 0.f, var = 0.f;
    const size_t row = (size_t)b * (size_t)K;
    for (int k = lane; k < K; k += 32) {
      const int f = idx[row + k];
      const bool live = f >= 0 && (long long)f < D;
      const float x = live ? val[row + k] : 0.f;
      const float wk = live ? w[f] : 0.f;
      s_idx[k] = live ? f : -1;
      s_val[k] = x;
      s_w[k] = wk;
      score += wk * x;
      sq += x * x;
      if (COV) {
        const float ck = live ? cov[f] : 1.f;
        s_cov[k] = ck;
        var += ck * x * x;
      }
      if (NS >= 1) s_s0[k] = live ? s0[f] : 0.f;
      if (NS >= 2) s_s1[k] = live ? s1[f] : 0.f;
    }
    score = warp_sum(score);
    sq = warp_sum(sq);
    if (COV) var = warp_sum(var);

    const RowOut o = row_rule<R>(hp, y, score, sq, var, g_m2, g_n);

    for (int k = lane; k < K; k += 32) {
      float dw, dcov, ds0, ds1;
      lane_deltas<R>(hp, o, t, s_val[k], s_w[k], COV ? s_cov[k] : 1.f,
                     NS >= 1 ? s_s0[k] : 0.f, NS >= 2 ? s_s1[k] : 0.f,
                     dw, dcov, ds0, ds1);
      s_dw[k] = dw;
      if (COV) s_dcov[k] = dcov;
      if (NS >= 1) s_ds0[k] = ds0;
      if (NS >= 2) s_ds1[k] = ds1;
    }
    __syncwarp();

    // apply: the first lane of each feature folds in every lane of it
    for (int k = lane; k < K; k += 32) {
      const int f = s_idx[k];
      if (f < 0) continue;
      bool leader = true;
      float aw = s_w[k];
      float ac = COV ? s_cov[k] : 0.f;
      float a0 = NS >= 1 ? s_s0[k] : 0.f;
      float a1 = NS >= 2 ? s_s1[k] : 0.f;
      int last = k;
      for (int j = 0; j < K; ++j) {
        if (s_idx[j] != f) continue;
        if (j < k) { leader = false; break; }
        aw += s_dw[j];
        if (COV) ac += s_dcov[j];
        if (NS >= 1) a0 += s_ds0[j];
        if (NS >= 2) a1 += s_ds1[j];
        last = j;
      }
      if (!leader) continue;
      if (DERIVE) {
        if (o.updated) w[f] = s_dw[last];
      } else {
        w[f] = aw;
      }
      if (COV) cov[f] = ac;
      if (NS >= 1) s0[f] = a0;
      if (NS >= 2) s1[f] = a1;
    }
    if (lane == 0) loss_out[b] = o.loss;
    __syncwarp();
  }
  if (GLOB && lane == 0) { glob[0] = g_m2; glob[1] = g_mean; glob[2] = g_n; }
}

// The row-serial latency floor of the scan, for measurement only (it is not
// on the training path): per row the dependent chain alone — load the row's
// ids and values, gather w at them, warp-sum w*x, write w back — with none
// of the rule's work. Row b+1's gather waits on row b's writes, as in the
// scan, so B rows take B chain latencies. Lanes repeating a feature write
// the same address with no defined winner; w's values are not the point.
__global__ void __launch_bounds__(32)
row_chain_floor_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
                       float* __restrict__ out, float* w, int B, int K, long long D) {
  const int lane = threadIdx.x;
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)b * (size_t)K;
    float s = 0.f;
    for (int k = lane; k < K; k += 32) {
      const int f = idx[row + k];
      if (f >= 0 && (long long)f < D) s += w[f] * val[row + k];
    }
    s = warp_sum(s);
    for (int k = lane; k < K; k += 32) {
      const int f = idx[row + k];
      if (f >= 0 && (long long)f < D) w[f] += 1e-7f * s * val[row + k];
    }
    if (lane == 0) out[b] = s;
    __syncwarp();
  }
}

template <int R>
int launch(const Hyper& hp, const int32_t* idx, const float* val, const float* y,
           float* loss, float* w, float* cov, float* s0, float* s1, float* glob,
           int B, int K, long long D, int step0, cudaStream_t stream) {
  const size_t smem = (size_t)K * SMEM_FLOATS_PER_LANE * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        linear_scan_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  linear_scan_kernel<R><<<1, 32, smem, stream>>>(hp, idx, val, y, loss, w, cov, s0,
                                                 s1, glob, B, K, D, step0);
  return (int)cudaGetLastError();
}

template <int R>
int dispatch(int rule, const Hyper& hp, const int32_t* idx, const float* val,
             const float* y, float* loss, float* w, float* cov, float* s0, float* s1,
             float* glob, int B, int K, long long D, int step0, cudaStream_t s) {
  if constexpr (R == N_RULES) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (rule == R) return launch<R>(hp, idx, val, y, loss, w, cov, s0, s1, glob, B, K, D, step0, s);
    return dispatch<R + 1>(rule, hp, idx, val, y, loss, w, cov, s0, s1, glob, B, K, D, step0, s);
  }
}

}  // namespace

extern "C" {

// Launch the scan of one block on `stream`. Pointers are device pointers
// except `hyper`, a host array of n_hyper floats. Tables (w, cov, s0, s1)
// and globals are updated in place; unused ones may be null. Returns the
// cudaError_t of the launch (0 on success); does not synchronize.
int hm_linear_scan(int rule, const float* hyper, int n_hyper, const int32_t* idx,
                   const float* val, const float* y, float* loss, float* w,
                   float* cov, float* s0, float* s1, float* glob, int B, int K,
                   long long D, int step0, void* stream) {
  if (n_hyper < 0 || n_hyper > MAX_HYPER || B < 0 || K < 1 || K > MAX_K)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Hyper hp{};
  for (int i = 0; i < n_hyper; ++i) hp.h[i] = hyper[i];
  return dispatch<0>(rule, hp, idx, val, y, loss, w, cov, s0, s1, glob, B, K, D, step0,
                     static_cast<cudaStream_t>(stream));
}

// The widest row (lanes) the scan takes: its shared memory holds the row.
int hm_linear_scan_max_k() { return MAX_K; }

// Launch row_chain_floor_kernel on `stream` (device pointers; w is
// overwritten). Returns the launch's cudaError_t; does not synchronize.
int hm_row_chain_floor(const int32_t* idx, const float* val, float* out, float* w, int B,
                       int K, long long D, void* stream) {
  if (B < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  row_chain_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(idx, val, out, w,
                                                                          B, K, D);
  return (int)cudaGetLastError();
}

const char* hm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
