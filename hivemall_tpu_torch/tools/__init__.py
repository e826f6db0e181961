"""Host-side tool UDFs (numpy copies of `hivemall_tpu/tools/`; `mapred`
reads its task id from torch.distributed)."""

from .array import (  # noqa: F401
    array_avg,
    array_concat,
    array_intersect,
    array_remove,
    array_sum,
    collect_all,
    float_array,
    sort_and_uniq_array,
    subarray,
    subarray_endwith,
    subarray_startwith,
    to_string_array,
)
from .bits import bits_collect, bits_or, to_bits, unbits  # noqa: F401
from .compress import deflate, inflate  # noqa: F401
from .map import map_get_sum, map_tail_n, to_map, to_ordered_map  # noqa: F401
from .math import sigmoid  # noqa: F401
from .misc import (  # noqa: F401
    convert_label,
    each_top_k,
    generate_series,
    x_rank,
)
from .text import (  # noqa: F401
    base91,
    is_stopword,
    normalize_unicode,
    split_words,
    tokenize,
    unbase91,
)
from .mapred import distcache_gets, jobconf_gets, jobid, rowid, taskid  # noqa: F401
from .convert import kdd_expand, libsvm_rows, one_vs_rest  # noqa: F401
