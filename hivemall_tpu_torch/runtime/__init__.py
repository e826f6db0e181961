from .cluster import cluster_env, init_cluster  # noqa: F401
from .metrics import Counter, MetricsRegistry, StopWatch, ThroughputCounter  # noqa: F401
from .tracing import TRACER, Tracer, step_span, sync_ready  # noqa: F401
