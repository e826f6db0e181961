from .metrics import Counter, MetricsRegistry, StopWatch, ThroughputCounter  # noqa: F401
from .tracing import TRACER, Tracer, sync_ready  # noqa: F401
