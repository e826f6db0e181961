"""SCW-I (Wang, Zhao and Hoi, "Exact Soft Confidence-Weighted Learning",
ICML 2012), as Hivemall's SoftConfideceWeightedUDTF trains it.

Two departures of the Java source from the paper are its semantics, and so
this reference's: alpha's margin term is the raw score, not y * score, and
a positive alpha is raised to at least C (Math.max(c, alpha); the paper
takes the minimum).

A row fires when loss = max(0, phi * sqrt(var) - y * score) > 0 and alpha
and beta are both non-zero; each lane then moves w_k by
y * alpha * cov_k * x_k and cov_k by -beta * (cov_k * x_k)^2.
"""

USES_COVARIANCE = True


def coefficients(score, var, y, hyper, ops):
    """(alpha, beta, fired) of a row (floats) or of rows (tensors); alpha
    and beta are 0 where the row does not fire."""
    phi, c = hyper["phi"], hyper["c"]
    loss = ops.maximum(phi * ops.sqrt(ops.maximum(var, 0.0)) - y * score,
                       0.0)
    sq_phi = phi * phi
    psi = 1.0 + sq_phi / 2.0
    zeta = 1.0 + sq_phi
    numer = -score * psi + ops.sqrt(ops.maximum(
        score * score * sq_phi * sq_phi / 4.0 + var * sq_phi * zeta, 0.0))
    alpha = ops.safe_div(numer, var * zeta)
    alpha = ops.where(alpha <= 0.0, 0.0, ops.maximum(alpha, c))
    beta_numer = alpha * phi
    var_alpha_phi = var * beta_numer
    u = -var_alpha_phi + ops.sqrt(ops.maximum(
        var_alpha_phi * var_alpha_phi + 4.0 * var, 0.0))
    beta = ops.safe_div(beta_numer, u / 2.0 + var_alpha_phi)
    fired = ops.logical_and(ops.logical_and(loss > 0.0, alpha != 0.0),
                            beta != 0.0)
    return ops.where(fired, alpha, 0.0), ops.where(fired, beta, 0.0), fired
