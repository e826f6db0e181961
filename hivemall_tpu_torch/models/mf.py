"""Matrix factorization: train_mf_sgd / train_mf_adagrad / train_bprmf,
mf_predict / bprmf_predict — the port of `hivemall_tpu/models/mf.py`.

Mirrors the reference MF subsystem (ref: mf/OnlineMatrixFactorizationUDTF.java:92-380,
mf/MatrixFactorizationSGDUDTF.java:33-65, mf/MatrixFactorizationAdaGradUDTF.java:34-125,
mf/BPRMatrixFactorizationUDTF.java:65-416, mf/FactorizedModel.java:45-120):

- rating model  r = mu + Bu + Bi + Pu.Qi  (bias clause optional)
- SGD:      Qi += eta*(err*Pu - lambda*Qi); Pu += eta*(err*Qi - lambda*Pu),
            both against the pre-update copies (ref: :280-296)
- AdaGrad:  per-element accumulated squared gradients with the x100 scaling
            trick, eta = eta0/sqrt(eps + G) (ref: MatrixFactorizationAdaGradUDTF.java:111-123)
- BPR:      triple (u, i, j): x_uij = (Bi + Pu.Qi) - (Bj + Pu.Qj), dloss in
            {sigmoid, logistic, lnLogistic}; Pu += eta*(dloss*(Qi - Qj) - regU*Pu);
            Qi += eta*(dloss*Pu - regI*Qi); Qj += eta*(-dloss*Pu - regJ*Qj);
            item biases likewise (ref: BPRMatrixFactorizationUDTF.java:311-416)

The JAX step is plain XLA (no Pallas kernel), so the port's step is plain
torch ops on the card: P [U, k] and Q [I, k] are dense tables, a block's
rows are row gathers, and the update is one ``index_add_`` per table.
``index_add_`` sums duplicate ids as ``.at[].add`` does; on CUDA it sums
them in atomic order, so floats may differ from the CPU in the last bits
while ``touched`` and ``step`` match exactly. BPR adds into Q (and Bi)
twice, positives then negatives, as the reference's two chained adds do.

Scan mode (the default ``-mini_batch 1``) replays rows one at a time
through the minibatch step's own row math on one-row slices: some 25
small launches a row on the card, launch-bound by design (a CUDA graph or
a hand kernel is later work, ROADMAP Queue 2 #4).

**Initial P and Q are the JAX package's.** JAX splits ``PRNGKey(seed)``
in two and draws P from the first half and Q from the second
(``uniform`` in [0, maxval) for ``rankinit="random"``, ``normal`` times
``min_init_stddev`` for "gaussian"). The port makes the same draw on the
host with ``utils/jax_prng`` (numpy threefry, equal to JAX's bits) and
copies the tables to the device, as FM's V is drawn — so a port run on
the card, one on the CPU and a JAX run start from the same tables.
`mf_state_from_numpy` still carries any JAX state across.

`step` is a host int (as in FMState). Steps update the state's tensors in
place and return the new state: treat the state passed in as consumed
(the JAX steps donate it).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.engine import _to_device
from ..core.state import _numpy
from ..device import DeviceLike, resolve_device
from ..ops.convergence import ConversionState
from ..ops.eta import EtaEstimator, get_eta
from ..utils import jax_prng
from ..utils.options import Options


@dataclass
class MFState:
    P: torch.Tensor  # [U, k]
    Q: torch.Tensor  # [I, k]
    Bu: torch.Tensor  # [U]
    Bi: torch.Tensor  # [I]
    mu: torch.Tensor  # []
    P_gg: Optional[torch.Tensor]  # [U, k] AdaGrad accumulators (scaled)
    Q_gg: Optional[torch.Tensor]
    touched_u: torch.Tensor  # [U] int8
    touched_i: torch.Tensor  # [I] int8
    step: int  # processed-example counter

    @property
    def device(self) -> torch.device:
        return self.P.device

    def replace(self, **changes) -> "MFState":
        return dataclasses.replace(self, **changes)


_TENSOR_FIELDS = ("P", "Q", "Bu", "Bi", "mu", "P_gg", "Q_gg", "touched_u",
                  "touched_i")


@dataclass(frozen=True)
class MFHyper:
    factor: int = 10
    lambda_: float = 0.03
    mu: float = 0.0
    update_mean: bool = False
    use_bias: bool = True
    rankinit: str = "random"
    maxval: float = 1.0
    min_init_stddev: float = 0.1
    eta: EtaEstimator = EtaEstimator("invscaling", 0.2, power_t=0.1)
    # adagrad
    adagrad: bool = False
    eps: float = 1.0
    scaling: float = 100.0
    seed: int = 31


@dataclass(frozen=True)
class BPRHyper:
    factor: int = 10
    loss: str = "lnLogistic"
    reg_u: float = 0.0025
    reg_i: float = 0.0025
    reg_j: float = 0.00125
    reg_bias: float = 0.01
    use_bias: bool = True
    rankinit: str = "random"
    maxval: float = 1.0
    min_init_stddev: float = 0.1
    eta: EtaEstimator = EtaEstimator("invscaling", 0.3, power_t=0.1)
    seed: int = 31

    # adapters so init_mf_state can be reused
    @property
    def mu(self):
        return 0.0

    @property
    def adagrad(self):
        return False


def init_mf_state(num_users: int, num_items: int, hyper,
                  device: DeviceLike = None) -> MFState:
    """A fresh model on ``device``: P and Q drawn on the host as JAX draws
    them, from the two halves of ``split(PRNGKey(hyper.seed))`` (uniform
    in [0, maxval) for ``rankinit="random"``, N(0, 1) times
    ``min_init_stddev`` for "gaussian"; see the module docstring), biases
    0, mu at ``hyper.mu``, AdaGrad accumulators 0 when ``hyper.adagrad``
    and None otherwise."""
    dev = resolve_device(device)
    k = hyper.factor
    ku, ki = jax_prng.split(hyper.seed)
    if hyper.rankinit == "gaussian":
        std = np.float32(hyper.min_init_stddev)
        P = jax_prng.normal(ku, (num_users, k)) * std
        Q = jax_prng.normal(ki, (num_items, k)) * std
    else:  # 'random' uniform in [0, maxval) (ref: Rating.rand init)
        P = jax_prng.uniform(ku, (num_users, k), 0.0, hyper.maxval)
        Q = jax_prng.uniform(ki, (num_items, k), 0.0, hyper.maxval)
    P, Q = torch.from_numpy(P), torch.from_numpy(Q)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return MFState(
        P=P.to(dev), Q=Q.to(dev),
        Bu=zeros(num_users), Bi=zeros(num_items),
        mu=torch.tensor(hyper.mu, dtype=torch.float32, device=dev),
        P_gg=zeros(num_users, k) if hyper.adagrad else None,
        Q_gg=zeros(num_items, k) if hyper.adagrad else None,
        touched_u=zeros(num_users, dtype=torch.int8),
        touched_i=zeros(num_items, dtype=torch.int8),
        step=0,
    )


def mf_state_from_numpy(d: dict, device: DeviceLike = None) -> MFState:
    """Build a state from the JAX MFState's fields as numpy arrays (``P``,
    ``Q``, ``Bu``, ``Bi``, ``mu``, ``P_gg``/``Q_gg`` or None,
    ``touched_u``, ``touched_i``, ``step``). Every tensor is a fresh
    copy."""
    dev = resolve_device(device)
    fields = {k: None if d.get(k) is None
              else torch.tensor(np.asarray(d[k]), device=dev)
              for k in _TENSOR_FIELDS}
    for k in ("touched_u", "touched_i"):
        fields[k] = fields[k].to(torch.int8)
    return MFState(step=int(d.get("step", 0)), **fields)


def mf_state_to_numpy(state: MFState) -> dict:
    """The inverse of `mf_state_from_numpy`: numpy copies of every field
    (None stays None), ``step`` as np.int32 (the JAX state's type)."""
    out = {k: None if getattr(state, k) is None else _numpy(getattr(state, k))
           for k in _TENSOR_FIELDS}
    out["step"] = np.int32(state.step)
    return out


def _apply_rows(st: MFState, u, i, dP, dQ, nb: int) -> MFState:
    """P[u] += dP, Q[i] += dQ (duplicates summed), touched set, step
    advanced by ``nb``."""
    st.P.index_add_(0, u, dP)
    st.Q.index_add_(0, i, dQ)
    st.touched_u.index_fill_(0, u, 1)
    st.touched_i.index_fill_(0, i, 1)
    return st.replace(step=st.step + nb)


def _ids(dev, *cols):
    """Id columns as int64 tensors on ``dev`` (no copy when they are
    already)."""
    return [_to_device(c, torch.int64, dev) for c in cols]


def _scan(state: MFState, cols, row_step):
    """Replay a block's rows one at a time through ``row_step(st, *row,
    eta) -> (st, loss[1])`` on one-row slices (the JAX scan's carry)."""
    b = cols[0].shape[0]
    # every row's eta at once, on the device: a row reads a view
    ts = (state.step + 1 + torch.arange(b, device=cols[0].device)).float()
    st, losses = state, []
    for row in range(b):
        sl = slice(row, row + 1)
        st, loss = row_step(st, *(c[sl] for c in cols), ts[sl])
        losses.append(loss)
    loss = torch.cat(losses).sum() if losses \
        else torch.zeros((), device=cols[0].device)
    return st, loss


def make_mf_step(hyper: MFHyper, mode: str = "minibatch",
                 device: DeviceLike = None):
    """Rating-MF block update: ``step(state, users [B], items [B],
    ratings [B]) -> (state, loss_sum)``. ``mode="scan"`` replays rows
    sequentially (reference-exact); ``"minibatch"`` computes every row's
    deltas against the block's start state (row t's eta at step + 1 + t)
    and adds them, duplicates summed."""
    if mode not in ("scan", "minibatch"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    lam = hyper.lambda_

    def rows_step(st: MFState, u, i, r, ts):
        """The rows' deltas against ``st``, then applied (vmap's
        semantics: no row sees another's update)."""
        eta = hyper.eta.eta(ts)  # [B]
        Pu, Qi = st.P[u], st.Q[i]
        bu = st.Bu[u] if hyper.use_bias else 0.0
        bi = st.Bi[i] if hyper.use_bias else 0.0
        pred = st.mu + bu + bi + torch.sum(Pu * Qi, dim=-1)
        err = r - pred
        e1 = err[:, None]
        gq = e1 * Pu - lam * Qi
        gp = e1 * Qi - lam * Pu
        if hyper.adagrad:
            # scaled accumulator trick (ref: MatrixFactorizationAdaGradUDTF.java:111-123)
            dggp = gp * (gp / hyper.scaling)
            dggq = gq * (gq / hyper.scaling)
            eta_p = hyper.eta.eta0 / torch.sqrt(
                hyper.eps + (st.P_gg[u] + dggp) * hyper.scaling)
            eta_q = hyper.eta.eta0 / torch.sqrt(
                hyper.eps + (st.Q_gg[i] + dggq) * hyper.scaling)
            dP, dQ = eta_p * gp, eta_q * gq
        else:
            dP, dQ = eta[:, None] * gp, eta[:, None] * gq
        if hyper.use_bias:
            dbu = eta * (err - lam * bu)
            dbi = eta * (err - lam * bi)
        st = _apply_rows(st, u, i, dP, dQ, u.shape[0])
        if hyper.use_bias:
            st.Bu.index_add_(0, u, dbu)
            st.Bi.index_add_(0, i, dbi)
            if hyper.update_mean:
                st = st.replace(mu=st.mu + torch.sum(eta * err))
        if hyper.adagrad:
            st.P_gg.index_add_(0, u, dggp)
            st.Q_gg.index_add_(0, i, dggq)
        return st, err * err

    def inputs(users, items, ratings):
        return _ids(dev, users, items) + [
            _to_device(ratings, torch.float32, dev)]

    def scan_step(state: MFState, users, items, ratings):
        return _scan(state, inputs(users, items, ratings), rows_step)

    def minibatch_step(state: MFState, users, items, ratings):
        u, i, r = inputs(users, items, ratings)
        ts = (state.step + 1 + torch.arange(u.shape[0], device=dev)).float()
        st, loss = rows_step(state, u, i, r, ts)
        return st, torch.sum(loss)

    return scan_step if mode == "scan" else minibatch_step


def make_bpr_step(hyper: BPRHyper, mode: str = "minibatch",
                  device: DeviceLike = None):
    """BPR block update: ``step(state, users [B], pos [B], neg [B]) ->
    (state, loss_sum)``, scan or minibatch as in `make_mf_step`."""
    if mode not in ("scan", "minibatch"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)

    def dloss_fn(x):
        if hyper.loss == "sigmoid":
            return 1.0 / (1.0 + torch.exp(x))
        if hyper.loss == "logistic":
            s = torch.sigmoid(x)
            return s * (1.0 - s)
        # lnLogistic (default): e^-x / (1 + e^-x) = sigmoid(-x)
        return torch.sigmoid(-x)

    def loss_fn(x):
        if hyper.loss == "lnLogistic":
            return torch.logaddexp(torch.zeros_like(x), -x)  # -ln sigmoid(x)
        return -x  # proxy

    def rows_step(st: MFState, u, i, j, ts):
        eta = hyper.eta.eta(ts)
        e1 = eta[:, None]
        Pu, Qi, Qj = st.P[u], st.Q[i], st.Q[j]
        bi = st.Bi[i] if hyper.use_bias else 0.0
        bj = st.Bi[j] if hyper.use_bias else 0.0
        x_uij = (bi + torch.sum(Pu * Qi, dim=-1)) \
            - (bj + torch.sum(Pu * Qj, dim=-1))
        g = dloss_fn(x_uij)
        g1 = g[:, None]
        dP = e1 * (g1 * (Qi - Qj) - hyper.reg_u * Pu)
        dQi = e1 * (g1 * Pu - hyper.reg_i * Qi)
        dQj = e1 * (-g1 * Pu - hyper.reg_j * Qj)
        if hyper.use_bias:
            dbi = eta * (g - hyper.reg_bias * bi)
            dbj = eta * (-g - hyper.reg_bias * bj)
        st = _apply_rows(st, u, i, dP, dQi, u.shape[0])
        # the reference's second chained add: Q.at[i].add(dQi).at[j].add(dQj)
        st.Q.index_add_(0, j, dQj)
        st.touched_i.index_fill_(0, j, 1)
        if hyper.use_bias:
            st.Bi.index_add_(0, i, dbi)
            st.Bi.index_add_(0, j, dbj)
        return st, loss_fn(x_uij)

    def scan_step(state: MFState, users, pos, neg):
        return _scan(state, _ids(dev, users, pos, neg), rows_step)

    def minibatch_step(state: MFState, users, pos, neg):
        u, i, j = _ids(dev, users, pos, neg)
        ts = (state.step + 1 + torch.arange(u.shape[0], device=dev)).float()
        st, loss = rows_step(state, u, i, j, ts)
        return st, torch.sum(loss)

    return scan_step if mode == "scan" else minibatch_step


def _checked_ids(ids, n: int, what: str) -> np.ndarray:
    """int64 ids with numpy's indexing rules (negative ids count from the
    end; anything outside [-n, n) raises IndexError), made non-negative —
    checked on the host so an out-of-range id never reaches a device
    gather."""
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size and (int(ids.min()) < -n or int(ids.max()) >= n):
        bad = ids[(ids < -n) | (ids >= n)][0]
        raise IndexError(f"{what} id {int(bad)} is out of bounds for a "
                         f"table of {n} rows")
    return np.where(ids < 0, ids + n, ids)


def _host_rows(table: torch.Tensor, ids: np.ndarray) -> np.ndarray:
    """float32 host copies of ``table``'s rows ``ids`` — gathered on the
    table's device, widened there (bf16 is value-exact in f32)."""
    idx = torch.from_numpy(ids).to(table.device)
    return table[idx].float().cpu().numpy()


@dataclass
class TrainedMFModel:
    state: MFState
    use_bias: bool

    def predict(self, users, items) -> np.ndarray:
        """r = mu + Bu + Bi + Pu.Qi (ref: MFPredictionUDF.java:33): rows
        gathered on the state's device, the dot in numpy f32 on the host
        (the JAX package's expression, bit for bit on the same rows)."""
        st = self.state
        u = _checked_ids(users, st.P.shape[0], "user")
        i = _checked_ids(items, st.Q.shape[0], "item")
        out = np.sum(_host_rows(st.P, u) * _host_rows(st.Q, i), axis=-1) \
            + float(st.mu)
        if self.use_bias:
            out = out + _host_rows(st.Bu, u) + _host_rows(st.Bi, i)
        return out

    def predict_bpr(self, users, items) -> np.ndarray:
        """BPR score = Bi + Pu.Qi (ref: BPRMFPredictionUDF.java)."""
        st = self.state
        u = _checked_ids(users, st.P.shape[0], "user")
        i = _checked_ids(items, st.Q.shape[0], "item")
        out = np.sum(_host_rows(st.P, u) * _host_rows(st.Q, i), axis=-1)
        if self.use_bias:
            out = out + _host_rows(st.Bi, i)
        return out

    def model_rows(self):
        """(idx, Pu, Qi, Bu, Bi, mu) — the reference's per-index emission
        (ref: OnlineMatrixFactorizationUDTF close/forward)."""
        st = self.state
        tu = np.nonzero(_numpy(st.touched_u))[0]
        ti = np.nonzero(_numpy(st.touched_i))[0]
        return {
            "users": (tu, _host_rows(st.P, tu), _host_rows(st.Bu, tu)),
            "items": (ti, _host_rows(st.Q, ti), _host_rows(st.Bi, ti)),
            "mu": float(st.mu),
        }


def _mf_options(bpr: bool = False) -> Options:
    o = Options()
    o.add("k", "factor", True, "Number of latent factors [default: 10]", default=10,
          type=int)
    o.add("iter", "iterations", True, "Iterations [default: 1]",
          default=30 if bpr else 1, type=int)
    o.add("rankinit", None, True, "Init strategy [random, gaussian]", default="random")
    o.add("maxval", "max_init_value", True, "Max initial value [default: 1.0]",
          default=1.0, type=float)
    o.add("min_init_stddev", None, True, "Gaussian init stddev [default: 0.1]",
          default=0.1, type=float)
    o.add("disable_cv", "disable_cvtest", False, "Disable convergence check")
    o.add("cv_rate", "convergence_rate", True, "Convergence rate [default: 0.005]",
          default=0.005, type=float)
    o.add("disable_bias", "no_bias", False, "Turn off bias clause")
    o.add("eta", None, True, "Fixed learning rate", type=float)
    o.add("eta0", None, True, "Initial learning rate", type=float)
    o.add("t", "total_steps", True, "Total steps", type=int)
    o.add("power_t", None, True, "Inverse scaling exponent [default 0.1]",
          default=0.1, type=float)
    o.add("boldDriver", "bold_driver", False, "Bold driver eta")
    o.add("seed", None, True, "Init seed", default=31, type=int)
    o.add("mini_batch", None, True, "Mini batch size [default 1 = exact scan]",
          default=1, type=int)
    if bpr:
        o.add("loss", "loss_function", True,
              "Loss [lnLogistic (default), logistic, sigmoid]", default="lnLogistic")
        o.add("reg", "lambda", True, "Regularization factor [default 0.0025]",
              default=0.0025, type=float)
        o.add("reg_u", "reg_user", True, "User regularization", type=float)
        o.add("reg_i", "reg_item", True, "Positive item regularization", type=float)
        o.add("reg_j", None, True, "Negative item regularization", type=float)
        o.add("reg_bias", None, True, "Bias regularization [default 0.01]",
              default=0.01, type=float)
    else:
        o.add("r", "lambda", True, "Regularization factor [default: 0.03]",
              default=0.03, type=float)
        o.add("mu", "mean_rating", True, "Mean rating [default: 0.0]", default=0.0,
              type=float)
        o.add("update_mean", "update_mu", False, "Update the mean rating")
        o.add("eps", None, True, "AdaGrad eps [default 1.0]", default=1.0, type=float)
        o.add("scale", None, True, "AdaGrad scaling [default 100]", default=100.0,
              type=float)
    return o


def _dims_from(idx, given: Optional[int]) -> int:
    return given if given is not None else int(np.max(idx)) + 1


def _fit(state: MFState, step, cols, cl, iters: int,
         block: int) -> MFState:
    """Epochs of ``step`` over the block-sliced ``cols`` (tensors on the
    state's device, uploaded once); the ConversionState stop of the JAX
    loop. Block losses stay on the device: ONE transfer per epoch, summed
    on the host in block order as the JAX loop sums them."""
    conv = ConversionState(not cl.has("disable_cv"),
                           cl.get_float("cv_rate", 0.005))
    n = cols[0].shape[0]
    for _ in range(max(1, iters)):
        losses = []
        for s in range(0, n, block):
            state, loss = step(state, *(c[s:s + block] for c in cols))
            losses.append(loss)
        conv.incr_loss(sum(torch.stack(losses).cpu().tolist()) if losses
                       else 0.0)
        if iters > 1 and conv.is_converged(n):
            break
    return state


def _train_rating_mf(users, items, ratings, options: Optional[str],
                     adagrad: bool, name: str, num_users=None,
                     num_items=None, device: DeviceLike = None
                     ) -> TrainedMFModel:
    cl = _mf_options().parse(options, name)
    dev = resolve_device(device)
    default_eta0 = 1.0 if adagrad else 0.2
    hyper = MFHyper(
        factor=cl.get_int("k", 10),
        lambda_=cl.get_float("r", 0.03),
        mu=cl.get_float("mu", 0.0),
        update_mean=cl.has("update_mean"),
        use_bias=not cl.has("disable_bias"),
        rankinit=cl.get("rankinit", "random"),
        maxval=cl.get_float("maxval", 1.0),
        min_init_stddev=cl.get_float("min_init_stddev", 0.1),
        eta=get_eta(cl, default_eta0),
        adagrad=adagrad,
        eps=cl.get_float("eps", 1.0),
        scaling=cl.get_float("scale", 100.0),
        seed=cl.get_int("seed", 31),
    )
    u = np.asarray(users, dtype=np.int32)
    i = np.asarray(items, dtype=np.int32)
    r = np.asarray(ratings, dtype=np.float32)
    state = init_mf_state(_dims_from(u, num_users), _dims_from(i, num_items),
                          hyper, device=dev)
    mini_batch = cl.get_int("mini_batch", 1)
    mode = "minibatch" if mini_batch > 1 else "scan"
    block = mini_batch if mode == "minibatch" else 8192
    cols = _ids(dev, u, i) + [_to_device(r, torch.float32, dev)]
    state = _fit(state, make_mf_step(hyper, mode, device=dev), cols, cl,
                 cl.get_int("iter", 1), block)
    return TrainedMFModel(state=state, use_bias=hyper.use_bias)


def train_mf_sgd(users, items, ratings, options: Optional[str] = None, **kw):
    """Rating MF by SGD on the CUDA device (``device="cpu"`` asks for the
    CPU). Default ``-mini_batch 1`` is the exact per-row scan (launch-
    bound on the card); ``-mini_batch B`` the stale-state minibatch."""
    return _train_rating_mf(users, items, ratings, options, False,
                            "train_mf_sgd", **kw)


def train_mf_adagrad(users, items, ratings, options: Optional[str] = None,
                     **kw):
    """Rating MF by AdaGrad; device and modes as `train_mf_sgd`."""
    return _train_rating_mf(users, items, ratings, options, True,
                            "train_mf_adagrad", **kw)


def train_bprmf(users, pos_items, neg_items, options: Optional[str] = None,
                num_users=None, num_items=None,
                device: DeviceLike = None) -> TrainedMFModel:
    """BPR-MF over (user, positive, negative) triples; device and modes as
    `train_mf_sgd`."""
    cl = _mf_options(bpr=True).parse(options, "train_bprmf")
    dev = resolve_device(device)
    reg = cl.get_float("reg", 0.0025)
    reg_i = cl.get_float("reg_i") if cl.has("reg_i") else reg
    hyper = BPRHyper(
        factor=cl.get_int("k", 10),
        loss=cl.get("loss", "lnLogistic"),
        reg_u=cl.get_float("reg_u") if cl.has("reg_u") else reg,
        reg_i=reg_i,
        reg_j=cl.get_float("reg_j") if cl.has("reg_j") else reg_i / 2.0,
        reg_bias=cl.get_float("reg_bias", 0.01),
        use_bias=not cl.has("disable_bias"),
        rankinit=cl.get("rankinit", "random"),
        maxval=cl.get_float("maxval", 1.0),
        min_init_stddev=cl.get_float("min_init_stddev", 0.1),
        eta=get_eta(cl, 0.3),
        seed=cl.get_int("seed", 31),
    )
    u = np.asarray(users, dtype=np.int32)
    i = np.asarray(pos_items, dtype=np.int32)
    j = np.asarray(neg_items, dtype=np.int32)
    nu = _dims_from(u, num_users)
    ni = _dims_from(np.concatenate([i, j]), num_items)
    mf_hyper = MFHyper(factor=hyper.factor, rankinit=hyper.rankinit,
                       maxval=hyper.maxval,
                       min_init_stddev=hyper.min_init_stddev,
                       seed=hyper.seed)
    state = init_mf_state(nu, ni, mf_hyper, device=dev)
    mini_batch = cl.get_int("mini_batch", 1)
    mode = "minibatch" if mini_batch > 1 else "scan"
    block = mini_batch if mode == "minibatch" else 8192
    state = _fit(state, make_bpr_step(hyper, mode, device=dev),
                 _ids(dev, u, i, j), cl, cl.get_int("iter", 30), block)
    return TrainedMFModel(state=state, use_bias=hyper.use_bias)


def mf_predict(Pu, Qi, Bu=0.0, Bi=0.0, mu=0.0) -> float:
    """`mf_predict(Pu, Qi[, Bu, Bi, mu])` (ref: mf/MFPredictionUDF.java:33)."""
    return float(np.dot(np.asarray(Pu), np.asarray(Qi)) + Bu + Bi + mu)


def bprmf_predict(Pu, Qi, Bi=0.0) -> float:
    """`bprmf_predict(Pu, Qi[, Bi])` (ref: mf/BPRMFPredictionUDF.java)."""
    return float(np.dot(np.asarray(Pu), np.asarray(Qi)) + Bi)
