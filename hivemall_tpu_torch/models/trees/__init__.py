from .forest import (  # noqa: F401
    forest_from_numpy,
    gbt_from_numpy,
    train_gradient_tree_boosting_classifier,
    train_randomforest_classifier,
    train_randomforest_regr,
)
from .predict import guess_attrs, tree_predict  # noqa: F401
from .vm import StackMachine  # noqa: F401
