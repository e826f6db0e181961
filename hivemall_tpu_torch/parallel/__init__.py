"""Multi-device training over ``torch.distributed`` (the port of
``hivemall_tpu/parallel``), exporting the names JAX's package does."""

from .mesh import make_mesh, make_mesh_2d  # noqa: F401
from .mix import MixConfig, MixTrainer, mix_average, mix_argmin_kld  # noqa: F401
from .sharded_train import (FFMShardedTrainer, FMShardedTrainer,  # noqa: F401
                            MCShardedTrainer, Sharded2DTrainer,
                            ShardedTrainer)
