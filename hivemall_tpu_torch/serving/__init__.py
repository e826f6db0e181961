"""Online inference for the port: frozen artifacts (the JAX package's
format, both ways), bucketed engines on the card, micro-batching with
priorities / quotas / deadlines / adaptive windows, and a hot-swap
registry behind POST /predict, and top-K retrieval over the MF and FM
catalogs behind POST /topk.

    from hivemall_tpu_torch.serving import freeze, ModelRegistry, serve

    freeze(model, "artifacts/ctr/1")
    registry = ModelRegistry()            # the CUDA device; device="cpu" asks
    registry.deploy("ctr", "artifacts/ctr/1")
    # or ModelRegistry(score_cache_bytes=64 << 20): the hot-row score cache
    server = serve(registry, port=8080)

    registry.deploy("rec", "artifacts/mf/1", retrieval={"k": 16})
    RetrievalEngine("artifacts/mf/1").topk([user_id])   # direct

    # tables striped over 4 stripes on the local devices (here one card)
    registry.deploy("big", "artifacts/fm/1",
                    placement=ModelSharded(4, devices=["cuda:0"] * 4))
"""

from .admission import (AIMDController, DeadlineExpired, PRIORITY_NAMES,
                        QueueFull, ShedLowPriority, priority_class)
from .artifact import Artifact, family_of, freeze, load
from .batcher import BatcherClosed, DynamicBatcher
from .cache import ScoreCache
from .engine import Servable, ServingEngine, make_servable
from .placement import (ModelExceedsDeviceBudget, ModelSharded, Placement,
                        Replicated, SingleDevice)
from .retrieval import RetrievalEngine, SRPIndex, build_srp_index
from .server import ModelEntry, ModelRegistry, serve

__all__ = [
    "Artifact", "family_of", "freeze", "load",
    "DynamicBatcher", "QueueFull", "BatcherClosed", "ScoreCache",
    "AIMDController", "DeadlineExpired", "ShedLowPriority",
    "PRIORITY_NAMES", "priority_class",
    "Servable", "ServingEngine", "make_servable",
    "Placement", "SingleDevice", "ModelSharded", "Replicated",
    "ModelExceedsDeviceBudget",
    "RetrievalEngine", "SRPIndex", "build_srp_index",
    "ModelRegistry", "ModelEntry", "serve",
]
