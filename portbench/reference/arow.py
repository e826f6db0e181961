"""AROW's closed form (Crammer, Kulesza and Dredze, "Adaptive
Regularization of Weight Vectors", NIPS 2009), as Hivemall's
AROWClassifierUDTF trains it.

A row with margin m = y * score and confidence var = sum(cov_k * x_k^2)
fires when m < 1. Then beta = 1 / (var + r) and alpha = (1 - m) * beta;
each lane moves w_k by y * alpha * cov_k * x_k and cov_k by
-beta * (cov_k * x_k)^2.
"""

USES_COVARIANCE = True


def coefficients(score, var, y, hyper, ops):
    """(alpha, beta, fired) of a row (floats) or of rows (tensors); alpha
    and beta are 0 where the row does not fire."""
    m = score * y
    fired = m < 1.0
    beta = 1.0 / (var + hyper["r"])
    return (ops.where(fired, (1.0 - m) * beta, 0.0),
            ops.where(fired, beta, 0.0), fired)
