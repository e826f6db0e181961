"""Mapred-context UDFs (ref: hivemall/tools/mapred/*.java).

These existed to expose Hadoop task context inside SQL. Here the "task" is a
rank of torch.distributed: taskid is the rank of the process group when one
is up and 0 otherwise; jobid is a stable per-run identifier (the
``HIVEMALL_TPU_JOB_ID`` variable when set, as in the JAX package); rowid
mirrors the reference's sprintf("%s-%d", taskid, seq) scheme
(ref: tools/mapred/RowIdUDF.java).
"""

from __future__ import annotations

import itertools
import os
import uuid
from typing import Optional

_JOB_ID = None
_ROW_COUNTER = itertools.count()


def taskid() -> int:
    """The rank of this process in the torch.distributed group, 0 when no
    group is up (ref: tools/mapred/TaskIdUDF.java)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def jobid() -> str:
    global _JOB_ID
    if _JOB_ID is None:
        _JOB_ID = os.environ.get("HIVEMALL_TPU_JOB_ID") or f"job_{uuid.uuid4().hex[:12]}"
    return _JOB_ID


def rowid() -> str:
    """Unique row id "taskid-seq" (ref: tools/mapred/RowIdUDF.java)."""
    return f"{taskid()}-{next(_ROW_COUNTER)}"


def jobconf_gets(key: Optional[str] = None, default: str = "") -> str:
    """JobConf lookup -> environment variables here
    (ref: tools/mapred/JobConfGetsUDF.java)."""
    if key is None:
        return " ".join(f"{k}={v}" for k, v in os.environ.items()
                        if k.startswith("HIVEMALL"))
    return os.environ.get(key.replace(".", "_").upper(), default)


def distcache_gets(path: str, key, default=None):
    """Distributed-cache key/value lookup -> local key-value file
    (ref: tools/mapred/DistributedCacheLookupUDF.java). The file holds
    tab-separated key\tvalue lines."""
    try:
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if parts and parts[0] == str(key):
                    return parts[1] if len(parts) > 1 else default
    except OSError:
        pass
    return default
