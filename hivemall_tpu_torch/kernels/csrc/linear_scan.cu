// Exact sequential scan of one feature block through a linear learner's
// closed-form rule — the CUDA counterpart of the Pallas kernel
// hivemall_tpu/kernels/linear_scan.py::_make_kernel (called through
// pallas_scan_raw). Built for sm_90a with nvcc, bound with ctypes
// (hivemall_tpu_torch/kernels/linear_scan.py holds the wrapper and the plain
// torch versions these kernels are tested against).
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
// Two kernels run per block.
//
// linear_scan_plan_kernel reads only idx and writes three int32 [B, K]
// tables:
//   lead[b,k] — the first lane of row b holding lane k's feature (-1: dead);
//   next[b,k] — the next lane of row b holding it, in lane order (-1: none),
//               so a leader folds its repeats without scanning the row;
//   fwd[b,k]  — (delta << 16) | lane: the latest earlier row b-delta of the
//               block, delta in 1..depth, that holds the feature, and that
//               row's leader lane of it; -1 if no row within depth does.
// What bounds it on an H100 is latency, not bytes (a main-path block's 2
// MB move in 0.6 us at 3.35 TB/s) or compares. A thread a (row, lane) pair
// scanning its row and the depth rows before it in device memory makes up
// to 288 dependent loads, and the 32 threads of a row repeat each other's.
// Instead a CTA takes a tile of consecutive rows: it copies their ids and
// the depth rows before them into shared memory once (16-byte loads at K =
// 32, each id read (tile + depth) / tile times), then a warp a row groups
// equal ids with __match_any_sync (lead and next are bit tricks on the
// group's mask) and its leader lanes insert id -> lane into the row's
// open-addressed table in shared memory. Each lane then probes the tables
// of the depth rows before it, their home slots loaded together: about
// depth lookups in place of K * depth compares. What is left is the launch
// and the CTA's three phases between barriers, each a short chain of
// dependent loads. K == 32 at depth DEPTH, the main path's block, has its
// own instance. Every scan depth's window fits in shared memory; a deeper
// one at a wide row does not, and is refused.
//
// linear_scan_kernel runs the rows in order as ONE CTA of ONE warp: row b+1
// reads what row b wrote. Thread `lane` owns lanes k = lane, lane+32, ...
// (any K). What bounds it on an H100 is latency, not bytes: a block's bytes
// would move in well under a microsecond, while its rows form one chain of
// dependent instructions. The design keeps device-memory round trips off
// that chain: the loads of row b+depth (its val, plan entries and y, and the
// gathers of every table at its live ids) are issued with cp.async into a
// shared-memory ring at the start of row b, and its idx two depths ahead, so
// the gathers have their addresses. A gather issued at the start of row b
// sees every write of rows <= b-1. Each row stores the table values it
// leaves, at its leader lanes, into a second ring of the last `depth` rows.
// At row b a lane whose plan entry names row b-delta takes that row's value
// from the ring; any other lane's prefetched value is current, because the
// latest row p that touched its feature has p <= b-depth-1, whose writes came
// before the gather. Rows' scalars are butterfly warp-shuffle sums, so every
// thread holds them. A leader sums its group's deltas in lane order by
// following next[] and writes each table once: no atomics, deterministic,
// the Pallas order. __syncwarp() orders the warp's global and shared stores
// before the next row's reads and copies; the tables are never read through
// the non-coherent (__ldg) path, since the kernel itself writes them.
// `depth` is DEPTH where the rings fit in shared memory, less for wide rows,
// and 0 (every load on the chain, no ring) for the widest. With one warp,
// every instruction's latency is on the chain, so K == 32 at depth DEPTH
// (hashed CTR rows bucket to 32 lanes) has its own instance with both as
// compile-time constants and each lane's values in registers.
//
// row_chain_floor_kernel (measurement only) runs the per-row chain of the
// unpipelined design alone — load the row's ids and values, gather w at
// them, one warp sum, write w back — as a like-for-like latency floor.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <stdint.h>

namespace {

// The kernel's rule forms, one X(ID, "rule name", "hyperparameters in the
// order of h[]") per line; a rule's id is its position. This table is the
// only record of ids and hyperparameter order: the Python wrapper reads it
// from this file (kernels/linear_scan.py::KERNEL_FORMS). Slots are passed
// sorted by name (ADAGRAD_RDA: sum_grad, sum_sqgrad; ADAGRAD_REGR:
// sum_sqgrad; ADADELTA_REGR: sum_sq_dx, sum_sqgrad) and globals too (m2,
// mean, n for PA1A_REGR, PA2A_REGR and AROWE2_REGR). LOGRESS's "schedule"
// is a code of HM_ETA_SCHEDULES.
#define HM_RULE_FORMS(X)                                        \
  X(PERCEPTRON, "perceptron", "")                               \
  X(PA, "pa", "")                                               \
  X(PA1, "pa1", "c")                                            \
  X(PA2, "pa2", "c")                                            \
  X(CW, "cw", "phi")                                            \
  X(AROW, "arow", "r")                                          \
  X(AROWH, "arowh", "r,c")                                      \
  X(SCW1, "scw1", "phi,c")                                      \
  X(SCW2, "scw2", "phi,c")                                      \
  X(ADAGRAD_RDA, "adagrad_rda", "eta,lambda,scale")             \
  X(ADAGRAD_REGR, "adagrad_regr", "eta,eps,scale")              \
  X(ADADELTA_REGR, "adadelta_regr", "rho,eps,scale")            \
  X(PA1_REGR, "pa1_regr", "c,epsilon")                          \
  X(PA1A_REGR, "pa1a_regr", "c,epsilon")                        \
  X(PA2_REGR, "pa2_regr", "c,epsilon")                          \
  X(PA2A_REGR, "pa2a_regr", "c,epsilon")                        \
  X(AROW_REGR, "arow_regr", "r")                                \
  X(AROWE_REGR, "arowe_regr", "r,epsilon")                      \
  X(AROWE2_REGR, "arowe2_regr", "r,epsilon")                    \
  X(LOGRESS, "logress", "schedule,eta0,total_steps,power_t")

#define HM_RULE_ID(id, name, keys) id,
enum RuleId : int { HM_RULE_FORMS(HM_RULE_ID) N_RULES };
#undef HM_RULE_ID

// The eta schedules of LOGRESS (ops/eta.py::EtaEstimator kinds), one
// X(ID, "kind") per line; a schedule's code is its position, read by the
// Python wrapper (kernels/linear_scan.py::ETA_SCHEDULES).
#define HM_ETA_SCHEDULES(X) \
  X(ETA_FIXED, "fixed")     \
  X(ETA_SIMPLE, "simple")   \
  X(ETA_INVSCALING, "invscaling") \
  X(ETA_ADJUSTING, "adjusting")

#define HM_ETA_ID(id, name) id,
enum EtaId : int { HM_ETA_SCHEDULES(HM_ETA_ID) };
#undef HM_ETA_ID

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
// tables the rule reads and writes: w, then cov, then its slots
__host__ __device__ constexpr int n_tables(int r) {
  return 1 + (uses_cov(r) ? 1 : 0) + n_slots(r);
}

constexpr float FLOAT_MAX = 3.4028235e38f;
constexpr unsigned FULL = 0xffffffffu;
// rows of look-ahead: enough rows of compute to cover one gather's latency
// (on an H100 the copies of a row issued 8 rows ahead have long landed when
// the row starts; 4 rows measured slightly slower)
constexpr int DEPTH = 8;
constexpr int FWD_SHIFT = 16;  // fwd entry = (delta << FWD_SHIFT) | lane
// the most dynamic shared memory one block may have on sm_90
constexpr int SMEM_LIMIT_BYTES = 232448;
constexpr int MAX_TABLES = 3;

// 32-bit words of shared memory the scan needs: per lane, the idx ring
// (2*depth+1 rows), the val / lead / next rings (depth+1 rows), the fwd ring
// (depth+1 rows, none at depth 0), the gathered-table ring (depth+1 rows per
// table), the forwarding ring (depth rows per table) and one delta per
// table; plus the y ring.
__host__ __device__ constexpr long long smem_words(int nt, int K, int depth) {
  return (long long)K * ((2 * depth + 1) + 3 * (depth + 1) + (depth > 0 ? depth + 1 : 0) +
                         nt * (depth + 1) + nt * depth + nt) +
         (depth + 1);
}
// the widest row any rule runs, at depth 0
constexpr int MAX_K = (SMEM_LIMIT_BYTES / 4 - 1) / (4 + 2 * MAX_TABLES);

// The look-ahead the scan uses for rule r at width K: DEPTH, or the most
// that fits in shared memory; -1 if not even depth 0 fits.
int scan_depth(int r, int K) {
  for (int d = DEPTH; d >= 0; --d)
    if (smem_words(n_tables(r), K, d) * 4 <= SMEM_LIMIT_BYTES) return d;
  return -1;
}

// ----------------------------------------------------------------- cp.async

// copy 4 bytes, of which the first src_bytes (4 or 0) are read and the
// rest filled with zeros
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gsrc,
                                          int src_bytes = 4) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gsrc),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// cp_async4 on the threads where `pred` holds, without a branch
__device__ __forceinline__ void cp_async4_if(bool pred, void* smem_dst, const void* gsrc) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(s),
      "l"(gsrc), "r"((int)pred)
      : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most n of this thread's copy groups are pending (n < DEPTH)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}
static_assert(DEPTH <= 8, "cp_async_wait_dyn covers waits up to 7 groups");

// --------------------------------------------------------------- row math

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

// eta(t) of an EtaEstimator (ops/eta.py): h = schedule, eta0, total_steps,
// power_t
__device__ __forceinline__ float eta_of(const float* h, float t) {
  const int kind = static_cast<int>(h[0]);
  if (kind == ETA_SIMPLE) return t > h[2] ? h[1] / 2.f : h[1] / (1.f + t / h[2]);
  if (kind == ETA_INVSCALING) return h[1] / powf(fmaxf(t, 1.f), h[3]);
  return h[1];  // fixed; adjusting is flat within an iteration
}

// The rule's row-level result: what every lane's delta is a function of.
struct RowOut {
  float loss;
  bool updated;
  float a;  // per-rule coefficient (see lane_deltas)
  float b;  // second coefficient
};

template <int R>
__device__ __forceinline__ RowOut row_rule(const Hyper& hp, float y, float t, float score,
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
  } else if (R == LOGRESS) {
    // (ref: LogressUDTF.java:78-82); regression.py::_make_logress_rule
    float g = logistic_grad(y, score);
    o.loss = g * g;
    o.updated = true;
    o.a = eta_of(h, t) * g;  // dw = a * x
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

// One lane's deltas, d[] in table order (w, cov, slots). For derive_w rules
// d[0] carries the lane's new w. v[] holds the lane's table values.
template <int R>
__device__ __forceinline__ void lane_deltas(const Hyper& hp, const RowOut& o, float t,
                                            float x, const float* v, float* d) {
  constexpr bool COV = uses_cov(R);
  const float* h = hp.h;
  const float w = v[0];
  const float cov = COV ? v[1] : 1.f;
  const float s0 = n_slots(R) >= 1 ? v[COV ? 2 : 1] : 0.f;
  const float s1 = n_slots(R) >= 2 ? v[COV ? 3 : 2] : 0.f;
  float dw = 0.f, dcov = 0.f, ds0 = 0.f, ds1 = 0.f;
  if (R == PERCEPTRON || R == PA || R == PA1 || R == PA2 || R == PA1_REGR ||
      R == PA1A_REGR || R == PA2_REGR || R == PA2A_REGR || R == LOGRESS) {
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
  d[0] = dw;
  if (COV) d[1] = dcov;
  if (n_slots(R) >= 1) d[COV ? 2 : 1] = ds0;
  if (n_slots(R) >= 2) d[COV ? 3 : 2] = ds1;
}

// ------------------------------------------------------------------ kernels

struct ScanArgs {
  const int32_t* idx;   // [B, K]
  const float* val;     // [B, K]
  const float* y;       // [B]
  const int32_t* lead;  // [B, K] plan tables
  const int32_t* next;
  const int32_t* fwd;
  float* loss;          // [B]
  float* tab[MAX_TABLES];  // the rule's tables in n_tables order, in place
  float* glob;          // m2, mean, n
  long long* cycles;    // [N_STAGES], timing instance only
  long long D;
  int B, K, step0, depth;
};

// the timing instance's stages of a row, in order; lane 0 adds the clock64()
// ticks between their boundaries over the block
#define HM_SCAN_STAGES "wait,issue,select,reduce,rule,deltas,fold,end"
constexpr int N_STAGES = 8;

// ------------------------------------------------------------------ the plan

// A row's table in shared memory: open addressing over plan_slots(K) slots,
// linear probing, each slot one 64-bit word (id << 32) | (first lane << 16)
// | last lane of the id in the row, PLAN_EMPTY while free. Live ids are in
// [0, 2^31), so no live entry has PLAN_EMPTY's id bits.
constexpr unsigned long long PLAN_EMPTY = ~0ull;
// rows a plan CTA writes (where they fit) and its warps: the least time of
// the shapes timed on an H100 (PERF.md, scripts/time_plan_kernel.py)
constexpr int PLAN_TILE_ROWS = 16;
constexpr int PLAN_WARPS = 16;

// slots of a row's table: at most a quarter full up to 64 lanes, half above
__host__ __device__ constexpr int plan_slots(int K) { return K <= 64 ? 4 * K : 2 * K; }
// shared-memory bytes of one row of a plan CTA's window: its table, its ids
__host__ __device__ constexpr long long plan_row_bytes(int K) {
  return 8LL * plan_slots(K) + 4LL * K;
}

// the id's home slot: the high bits of a multiplicative hash, spread over S
// slots without a power of two (ids equal modulo 2^n land apart)
__device__ __forceinline__ unsigned plan_slot(int f, int S) {
  return (unsigned)(((unsigned long long)((unsigned)f * 0x9E3779B1u) * (unsigned)S) >> 32);
}

// NARROW: K == 32 at depth DEPTH (the main path's block) with K and depth
// compile-time constants and the ids loaded 16 bytes a thread. A CTA writes
// rows [r0, r0 + tile) and holds the window [w0, r0 + tile) of them and the
// depth rows before them.
template <bool NARROW>
__global__ void __launch_bounds__(PLAN_WARPS * 32)
linear_scan_plan_kernel(const int32_t* __restrict__ idx, int32_t* __restrict__ lead,
                        int32_t* __restrict__ next, int32_t* __restrict__ fwd, int B,
                        int K_, long long D, int depth_, int tile) {
  const int K = NARROW ? 32 : K_;
  const int depth = NARROW ? DEPTH : depth_;
  const int S = plan_slots(K);
  const int r0 = blockIdx.x * tile;
  const int r1 = min(B, r0 + tile);
  const int w0 = max(0, r0 - depth);
  const int nw = r1 - w0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ unsigned long long plan_smem[];
  unsigned long long* tab = plan_smem;                       // [nw][S]
  int* ids = reinterpret_cast<int*>(tab + (size_t)nw * S);  // [nw][K]

  // 1. the window's ids in one coalesced sweep; every table empty
  const size_t base = (size_t)w0 * K, n = (size_t)nw * K;
  if (NARROW) {
    const int4* src = reinterpret_cast<const int4*>(idx + base);
    int4* dst = reinterpret_cast<int4*>(ids);
    for (int i = threadIdx.x; i < (int)(n / 4); i += blockDim.x) dst[i] = src[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) ids[i] = idx[base + i];
  }
  for (size_t i = threadIdx.x; i < (size_t)nw * S; i += blockDim.x) tab[i] = PLAN_EMPTY;
  __syncthreads();

  // 2. a warp a row: the row's table, and lead and next of the rows this CTA
  // writes. 32 lanes at a time: __match_any_sync groups a chunk's equal ids
  // (a live id never equals a dead one), the group's lowest lane finds or
  // inserts the id; an id seen in an earlier chunk (K > 32) takes its first
  // lane from the table, links its last lane there to this chunk's first
  // and moves the last lane on.
  for (int w = warp; w < nw; w += PLAN_WARPS) {
    const int r = w0 + w;
    const bool own = r >= r0;
    const int* row = ids + (size_t)w * K;
    unsigned long long* t = tab + (size_t)w * S;
    const size_t g = (size_t)r * K;
    for (int c = 0; c < K; c += 32) {
      const int k = c + lane;
      const int f = k < K ? row[k] : -1;
      const bool live = k < K && f >= 0 && (long long)f < D;
      const unsigned grp = __match_any_sync(FULL, f);
      const int lo = __ffs(grp) - 1, hi = 31 - __clz(grp);
      const unsigned above = grp & (0xfffffffeu << lane);
      int first = c + lo;
      if (live && lane == lo) {
        const unsigned long long mine = ((unsigned long long)(unsigned)f << 32) |
                                        ((unsigned long long)(c + lo) << 16) |
                                        (unsigned)(c + hi);
        unsigned s = plan_slot(f, S);
        for (;;) {
          const unsigned long long e = atomicCAS(&t[s], PLAN_EMPTY, mine);
          if (e == PLAN_EMPTY) break;
          if ((unsigned)(e >> 32) == (unsigned)f) {
            first = (int)((e >> 16) & 0xffff);
            t[s] = (e & ~0xffffull) | (unsigned)(c + hi);
            if (own) next[g + (e & 0xffff)] = c + lo;
            break;
          }
          if (++s == (unsigned)S) s = 0;
        }
      }
      first = __shfl_sync(FULL, first, lo);
      if (own && k < K) {
        lead[g + k] = live ? first : -1;
        next[g + k] = live && above ? c + __ffs(above) - 1 : -1;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. fwd of the rows this CTA writes: each live lane loads its id's home
  // slot in the tables of the depth rows before it together (one table
  // size, one home slot), then walks them nearest first, probing on past
  // a collision, and stops at the first row that holds the id
  for (int w = r0 - w0 + warp; w < nw; w += PLAN_WARPS) {
    const int r = w0 + w;
    const int* row = ids + (size_t)w * K;
    const size_t g = (size_t)r * K;
    const int dmax = min(depth, r);
    for (int k = lane; k < K; k += 32) {
      const int f = row[k];
      int e = -1;
      if (f >= 0 && (long long)f < D) {
        const unsigned home = plan_slot(f, S);
        unsigned long long x[DEPTH];
#pragma unroll
        for (int d = 1; d <= DEPTH; ++d)
          x[d - 1] = d <= dmax ? tab[(size_t)(w - d) * S + home] : PLAN_EMPTY;
#pragma unroll
        for (int d = 1; d <= DEPTH; ++d) {
          unsigned long long y = x[d - 1];
          unsigned s = home;
          while (y != PLAN_EMPTY && (unsigned)(y >> 32) != (unsigned)f) {
            if (++s == (unsigned)S) s = 0;
            y = tab[(size_t)(w - d) * S + s];
          }
          if (y != PLAN_EMPTY) {
            e = (d << FWD_SHIFT) | (int)((y >> 16) & 0xffff);
            break;
          }
        }
      }
      fwd[g + k] = e;
    }
  }
}

// NARROW: K == 32 (the bucketed width of hashed CTR rows) at depth DEPTH,
// one lane a thread, every lane's values in registers, and K and depth
// compile-time constants.
template <int R, bool TIMED, bool NARROW>
__global__ void __launch_bounds__(32) linear_scan_kernel(Hyper hp, ScanArgs a) {
  constexpr bool COV = uses_cov(R);
  constexpr bool GLOB = has_globals(R);
  constexpr bool DERIVE = derives_w(R);
  constexpr int NT = n_tables(R);

  const int K = NARROW ? 32 : a.K;
  const int B = a.B, depth = NARROW ? DEPTH : a.depth;
  const int lane = threadIdx.x;
  float* tab[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) tab[q] = a.tab[q];

  // shared-memory rings (see smem_words); row r's slot is r % (2*depth+1)
  // in s_idx, r % (depth+1) in the prefetch rings, r % depth in s_fw
  extern __shared__ float smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_x = smem + (2 * depth + 1) * K;
  int* s_lead = reinterpret_cast<int*>(s_x + (depth + 1) * K);
  int* s_next = s_lead + (depth + 1) * K;
  int* s_fwd = s_next + (depth + 1) * K;
  float* s_g = reinterpret_cast<float*>(s_fwd + (depth > 0 ? (depth + 1) * K : 0));
  float* s_fw = s_g + NT * (depth + 1) * K;  // [NT][depth][K]
  float* s_d = s_fw + NT * depth * K;        // [NT][K]
  float* s_y = s_d + NT * K;                 // [depth+1]
  auto g_at = [&](int q, int slot, int k) -> float& {
    return s_g[(q * (depth + 1) + slot) * K + k];
  };

// the lanes k this thread owns; `first` is k == lane
#define HM_FOR_LANES(k, first)                                                  \
  for (int k = lane, it_ = 0; k < K && (!NARROW || it_ == 0); k += 32, ++it_) \
    if (const bool first = NARROW || it_ == 0; true)

  // idx of row r into its ring slot il
  auto stage_idx = [&](int r, int il) {
    HM_FOR_LANES(k, first) cp_async4(&s_idx[il * K + k], &a.idx[r * K + k]);
  };
  // row r's val, plan entries and y into ring slot sl, and the gathers of
  // its tables at its live ids (its idx already in slot il of s_idx); a
  // dead lane's copies read nothing and fill 0 (its cov is set to 1 when
  // it is read)
  auto stage_row = [&](int r, int sl, int il) {
    HM_FOR_LANES(k, first) {
      const int g = r * K + k;
      const int f = s_idx[il * K + k];
      const bool live = f >= 0 && (long long)f < a.D;
      const int bytes = live ? 4 : 0;
      const int fs = live ? f : 0;
      cp_async4(&s_lead[sl * K + k], &a.lead[g]);
      cp_async4(&s_next[sl * K + k], &a.next[g]);
      if (depth > 0) cp_async4(&s_fwd[sl * K + k], &a.fwd[g]);
      cp_async4(&s_x[sl * K + k], &a.val[g], bytes);
#pragma unroll
      for (int q = 0; q < NT; ++q) cp_async4(&g_at(q, sl, k), &tab[q][fs], bytes);
    }
    cp_async4_if(lane == 0, &s_y[sl], &a.y[r]);
  };

  // Welford state (globals sorted by name: m2, mean, n), same in every thread
  float g_m2 = 0.f, g_mean = 0.f, g_n = 0.f;
  if (GLOB) { g_m2 = a.glob[0]; g_mean = a.glob[1]; g_n = a.glob[2]; }
  long long cyc[N_STAGES];
#pragma unroll
  for (int s = 0; s < N_STAGES; ++s) cyc[s] = 0;

  // prologue: idx of rows 0..depth-1 in place, then one copy group per row
  // r < depth holding row r and idx of row r+depth
  if (depth > 0) {
    for (int r = 0; r < depth && r < B; ++r) stage_idx(r, r);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    for (int r = 0; r < depth; ++r) {
      if (r < B) stage_row(r, r, r);
      if (r + depth < B) stage_idx(r + depth, r + depth);
      cp_async_commit();
    }
  }

  int ib = 0, sb = 0, fb = 0;  // row b's slots in the three rings
  for (int b = 0; b < B; ++b) {
    long long c0 = TIMED ? clock64() : 0, c1;
    if (depth == 0) {
      stage_idx(b, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      stage_row(b, 0, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      if (TIMED) { c1 = clock64(); cyc[0] += c1 - c0; c0 = c1; }
    } else {
      // row b's group (issued depth rows ago) has landed: this thread's
      // copies are visible to it; no lane reads another lane's copies before
      // the __syncwarp that ends the deltas (y comes from lane 0 by shuffle)
      if (NARROW) cp_async_wait<DEPTH - 1>();
      else cp_async_wait_dyn(depth - 1);
      if (TIMED) { c1 = clock64(); cyc[0] += c1 - c0; c0 = c1; }
      // slots of row b+depth: the one row b-1 left in the prefetch rings,
      // ib+depth in s_idx; idx of row b+2*depth takes row b-1's s_idx slot
      if (b + depth < B) {
        const int il = ib + depth;
        stage_row(b + depth, sb == 0 ? depth : sb - 1,
                  il >= 2 * depth + 1 ? il - (2 * depth + 1) : il);
      }
      if (b + 2 * depth < B) stage_idx(b + 2 * depth, ib == 0 ? 2 * depth : ib - 1);
      cp_async_commit();
      if (TIMED) { c1 = clock64(); cyc[1] += c1 - c0; c0 = c1; }
    }

    // select: each lane's table values at the start of row b, from the
    // forwarding ring or the prefetch; a thread's first lane keeps its own in
    // registers, its other lanes go back to the prefetch ring
    float score = 0.f, sq = 0.f, var = 0.f;
    float x0 = 0.f, v0[NT];
    int f0 = -1, lead0 = -1, next0 = -1;
#pragma unroll
    for (int q = 0; q < NT; ++q) v0[q] = 0.f;
    HM_FOR_LANES(k, first) {
      const int at = sb * K + k;
      const float x = s_x[at];
      const int lead = s_lead[at];
      const int fw = depth > 0 ? s_fwd[at] : -1;
      const int dist = fw >> FWD_SHIFT;
      // without a branch: both candidates are read, the plan picks one
      const bool fwd_it = fw >= 0 && dist <= depth;
      int src = fb - dist;
      if (src < 0) src += depth;
      const int from = fwd_it ? src * K + (fw & ((1 << FWD_SHIFT) - 1)) : 0;
      float v[NT];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const float ring = depth > 0 ? s_fw[q * depth * K + from] : 0.f;
        const float pre = (COV && q == 1 && lead < 0) ? 1.f : g_at(q, sb, k);
        v[q] = fwd_it ? ring : pre;
      }
      score += v[0] * x;
      sq += x * x;
      if (COV) var += v[1] * x * x;
      if (first) {
        x0 = x; lead0 = lead; next0 = s_next[at]; f0 = s_idx[ib * K + k];
#pragma unroll
        for (int q = 0; q < NT; ++q) v0[q] = v[q];
      } else {
#pragma unroll
        for (int q = 0; q < NT; ++q) g_at(q, sb, k) = v[q];
      }
    }
    if (TIMED) { c1 = clock64(); cyc[2] += c1 - c0; c0 = c1; }
    score = warp_sum(score);
    sq = warp_sum(sq);
    if (COV) var = warp_sum(var);
    if (TIMED) { c1 = clock64(); cyc[3] += c1 - c0; c0 = c1; }

    const float y = __shfl_sync(FULL, s_y[sb], 0);
    const float t = (float)(a.step0 + b + 1);
    if (GLOB) {
      float n1 = g_n + 1.f;
      float delta = y - g_mean;
      float mean1 = g_mean + delta / n1;
      g_m2 = g_m2 + delta * (y - mean1);
      g_mean = mean1;
      g_n = n1;
    }
    const RowOut o = row_rule<R>(hp, y, t, score, sq, var, g_m2, g_n);
    if (TIMED) { c1 = clock64(); cyc[4] += c1 - c0; c0 = c1; }

    // deltas: a lane publishes its own unless it is its thread's first lane
    // and leads its group (then they stay in registers)
    float d0[NT];
    HM_FOR_LANES(k, first) {
      float v[NT], d[NT];
#pragma unroll
      for (int q = 0; q < NT; ++q) v[q] = first ? v0[q] : g_at(q, sb, k);
      lane_deltas<R>(hp, o, t, first ? x0 : s_x[sb * K + k], v, d);
      if (first) {
#pragma unroll
        for (int q = 0; q < NT; ++q) d0[q] = d[q];
      }
      if (!first || lead0 != k) {
#pragma unroll
        for (int q = 0; q < NT; ++q) s_d[q * K + k] = d[q];
      }
    }
    __syncwarp();
    if (TIMED) { c1 = clock64(); cyc[5] += c1 - c0; c0 = c1; }

    // fold: each leader sums its group's deltas in lane order, then writes
    // the tables and the forwarding ring once
    HM_FOR_LANES(k, first) {
      if ((first ? lead0 : s_lead[sb * K + k]) != k) continue;  // dead or not a leader
      float v[NT], acc[NT];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        v[q] = first ? v0[q] : g_at(q, sb, k);
        acc[q] = v[q] + (first ? d0[q] : s_d[q * K + k]);
      }
      float last = first ? d0[0] : s_d[k];
      for (int n = first ? next0 : s_next[sb * K + k]; n >= 0; n = s_next[sb * K + n]) {
#pragma unroll
        for (int q = 0; q < NT; ++q) acc[q] += s_d[q * K + n];
        last = s_d[n];
      }
      const int f = first ? f0 : s_idx[ib * K + k];
      float nw;
      if (DERIVE) {
        nw = o.updated ? last : v[0];
        if (o.updated) tab[0][f] = nw;
      } else {
        nw = acc[0];
        tab[0][f] = nw;
      }
#pragma unroll
      for (int q = 1; q < NT; ++q) tab[q][f] = acc[q];
      if (depth > 0) {
#pragma unroll
        for (int q = 0; q < NT; ++q)
          s_fw[(q * depth + fb) * K + k] = q == 0 ? nw : acc[q];
      }
    }
#undef HM_FOR_LANES
    if (TIMED) { c1 = clock64(); cyc[6] += c1 - c0; c0 = c1; }
    if (lane == 0) a.loss[b] = o.loss;
    __syncwarp();
    if (TIMED) { c1 = clock64(); cyc[7] += c1 - c0; }

    if (++ib == 2 * depth + 1) ib = 0;
    if (++sb == depth + 1) sb = 0;
    if (depth > 0 && ++fb == depth) fb = 0;
  }
  if (GLOB && lane == 0) { a.glob[0] = g_m2; a.glob[1] = g_mean; a.glob[2] = g_n; }
  if (TIMED && lane == 0) {
#pragma unroll
    for (int s = 0; s < N_STAGES; ++s) a.cycles[s] = cyc[s];
  }
}

// The row-serial latency floor of the unpipelined scan, for measurement only
// (it is not on the training path): per row the dependent chain alone — load
// the row's ids and values, gather w at them, warp-sum w*x, write w back —
// with none of the rule's work. Row b+1's gather waits on row b's writes, so
// B rows take B chain latencies. Lanes repeating a feature write the same
// address with no defined winner; w's values are not the point.
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

template <int R, bool TIMED, bool NARROW>
int launch_as(const Hyper& hp, const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)smem_words(n_tables(R), a.K, a.depth) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(linear_scan_kernel<R, TIMED, NARROW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  linear_scan_kernel<R, TIMED, NARROW><<<1, 32, smem, stream>>>(hp, a);
  return (int)cudaGetLastError();
}

template <int R, bool TIMED>
int launch(const Hyper& hp, const ScanArgs& a, cudaStream_t stream) {
  return a.K == 32 && a.depth == DEPTH ? launch_as<R, TIMED, true>(hp, a, stream)
                                       : launch_as<R, TIMED, false>(hp, a, stream);
}

template <int R>
int dispatch(int rule, const Hyper& hp, const ScanArgs& a, cudaStream_t s) {
  if constexpr (R == N_RULES) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (rule == R) return launch<R, false>(hp, a, s);
    return dispatch<R + 1>(rule, hp, a, s);
  }
}

int check_and_pack(int rule, const float* hyper, int n_hyper, int B, int K, int depth,
                   Hyper& hp) {
  if (rule < 0 || rule >= N_RULES || n_hyper < 0 || n_hyper > MAX_HYPER || B < 0 ||
      K < 1 || K > MAX_K || (long long)B * K > 0x7fffffffLL || depth < 0 ||
      depth > scan_depth(rule, K))
    return (int)cudaErrorInvalidValue;
  hp = Hyper{};
  for (int i = 0; i < n_hyper; ++i) hp.h[i] = hyper[i];
  return 0;
}

ScanArgs pack_args(const int32_t* idx, const float* val, const float* y,
                   const int32_t* lead, const int32_t* next, const int32_t* fwd,
                   float* loss, float* w, float* cov, float* s0, float* s1, float* glob,
                   int B, int K, long long D, int step0, int depth, int rule) {
  ScanArgs a{};
  a.idx = idx; a.val = val; a.y = y; a.lead = lead; a.next = next; a.fwd = fwd;
  a.loss = loss; a.glob = glob; a.D = D; a.B = B; a.K = K; a.step0 = step0;
  a.depth = depth;
  int t = 0;
  a.tab[t++] = w;
  if (uses_cov(rule)) a.tab[t++] = cov;
  if (n_slots(rule) >= 1) a.tab[t++] = s0;
  if (n_slots(rule) >= 2) a.tab[t++] = s1;
  return a;
}

}  // namespace

extern "C" {

// Launch the scan of one block on `stream`. Pointers are device pointers
// except `hyper`, a host array of n_hyper floats. lead / next / fwd are the
// block's plan (hm_linear_scan_plan at the same depth). Tables (w, cov, s0,
// s1) and globals are updated in place; unused ones may be null. `depth`
// must not exceed hm_linear_scan_depth(rule, K). Returns the cudaError_t of
// the launch (0 on success); does not synchronize.
int hm_linear_scan(int rule, const float* hyper, int n_hyper, const int32_t* idx,
                   const float* val, const float* y, const int32_t* lead,
                   const int32_t* next, const int32_t* fwd, float* loss, float* w,
                   float* cov, float* s0, float* s1, float* glob, int B, int K,
                   long long D, int step0, int depth, void* stream) {
  Hyper hp;
  int rc = check_and_pack(rule, hyper, n_hyper, B, K, depth, hp);
  if (rc != 0 || B == 0) return rc;
  const ScanArgs a = pack_args(idx, val, y, lead, next, fwd, loss, w, cov, s0, s1, glob,
                               B, K, D, step0, depth, rule);
  return dispatch<0>(rule, hp, a, static_cast<cudaStream_t>(stream));
}

// The timing instance of the scan (AROW only, for measurement): the same
// arguments, plus `cycles`, a device array of one int64 per stage named by
// hm_linear_scan_stage_names(), which receives lane 0's clock64() ticks per
// stage summed over the block.
int hm_linear_scan_stage_cycles(const float* hyper, int n_hyper, const int32_t* idx,
                                const float* val, const float* y, const int32_t* lead,
                                const int32_t* next, const int32_t* fwd, float* loss,
                                float* w, float* cov, int B, int K, long long D, int step0,
                                int depth, long long* cycles, void* stream) {
  Hyper hp;
  int rc = check_and_pack(AROW, hyper, n_hyper, B, K, depth, hp);
  if (rc != 0 || B == 0) return rc;
  ScanArgs a = pack_args(idx, val, y, lead, next, fwd, loss, w, cov, nullptr, nullptr,
                         nullptr, B, K, D, step0, depth, AROW);
  a.cycles = cycles;
  return launch<AROW, true>(hp, a, static_cast<cudaStream_t>(stream));
}

const char* hm_linear_scan_stage_names() { return HM_SCAN_STAGES; }

// 1 if hm_linear_scan_plan launches the narrow instance for these ids (K ==
// 32 at depth DEPTH, ids 16-byte aligned), else 0.
int hm_linear_scan_plan_narrow(const int32_t* idx, int K, int depth) {
  return K == 32 && depth == DEPTH && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
}

// Build the plan of a block (int32 [B, K] lead, next, fwd; see the top of
// this file) on `stream`, forwarding over at most `depth` rows. Refuses
// (cudaErrorInvalidValue) a window of depth + 1 rows that does not fit in
// shared memory: K (depth + 1) > 11,622 lanes above 64 lanes a row, past
// every scan depth (scan_depth keeps K (depth + 1) <= 7,748). Returns the
// launch's cudaError_t; does not synchronize.
int hm_linear_scan_plan(const int32_t* idx, int32_t* lead, int32_t* next, int32_t* fwd,
                        int B, int K, long long D, int depth, void* stream) {
  const long long row_bytes = plan_row_bytes(K);
  if (B < 0 || K < 1 || K > MAX_K || depth < 0 || depth > DEPTH ||
      (long long)B * K > 0x7fffffffLL || (depth + 1) * row_bytes > SMEM_LIMIT_BYTES)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  // rows a CTA writes: PLAN_TILE_ROWS, fewer where its window would not fit
  const int tile = (int)std::min<long long>(PLAN_TILE_ROWS,
                                            SMEM_LIMIT_BYTES / row_bytes - depth);
  const size_t smem = (size_t)(std::min(tile + depth, B) * row_bytes);
  const unsigned grid = (unsigned)((B + tile - 1) / tile);
  auto kernel = hm_linear_scan_plan_narrow(idx, K, depth) ? linear_scan_plan_kernel<true>
                                                          : linear_scan_plan_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, PLAN_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, lead, next, fwd, B, K, D, depth, tile);
  return (int)cudaGetLastError();
}

// The look-ahead (rows) the scan runs rule `rule` with at width K; -1 if
// the rule is unknown or K is wider than the scan takes.
int hm_linear_scan_depth(int rule, int K) {
  if (rule < 0 || rule >= N_RULES || K < 1 || K > MAX_K) return -1;
  return scan_depth(rule, K);
}

// The widest row (lanes) the scan takes, for every rule: at depth 0 its
// shared memory holds one row.
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
