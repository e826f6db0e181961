from .arrow import (arrow_ops, model_from_arrow, model_to_arrow,  # noqa: F401
                    predict_batches, read_model_ipc, write_model_ipc)
from .dataframe import HivemallFrame, hivemall_ops  # noqa: F401
