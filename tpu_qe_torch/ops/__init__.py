"""Query operators (the port of tpu_qe/ops).

Every data sort goes through tpu_qe_torch.sort.planes (the radix kernels
on the card; ``backend="torch"`` for the torch.sort baseline in the
in-core operators).

The out-of-core family is exported lazily (PEP 562), as in the reference:
its modules import the sort drivers, which import ops.join, so eager
imports here would cycle through this package's init. The map is the
reference's: the single-device modules (bigagg, bigjoin, bigpipe,
bigouter, bigtopk, bigdistinct, bigsetops, bigquantile, bigwindow,
bigorderby) and the distributed ones over a mesh of shards (dbigagg,
dbigjoin, dbigpipe, dbigtopk, dbigdistinct, dbigsetops, dbigquantile,
dbigwindow, dbigorderby).
"""

from tpu_qe_torch.ops.filter import compact, filter_table  # noqa: F401
from tpu_qe_torch.ops.aggregate import (group_aggregate,  # noqa: F401
                                        group_aggregate_multi,
                                        group_aggregate_sorted)
from tpu_qe_torch.ops.join import (expand_ranges, join_fk,  # noqa: F401
                                   join_fk_scan, join_inner, join_outer,
                                   join_sorted)
from tpu_qe_torch.ops.orderby import sort_by_multi  # noqa: F401
from tpu_qe_torch.ops.setops import set_op  # noqa: F401
from tpu_qe_torch.ops.quantile import (group_quantile, median,  # noqa: F401
                                       quantile)
from tpu_qe_torch.ops.topk import top_k  # noqa: F401
from tpu_qe_torch.ops.window import window  # noqa: F401

_BIG_EXPORTS = {
    "aggregate_big": "bigagg",
    "aggregate_big_multi": "bigagg",
    "join_big": "bigjoin",
    "join_big_outer": "bigouter",
    "count_distinct_big": "bigdistinct",
    "count_distinct_big_distributed": "dbigdistinct",
    "set_op_big": "bigsetops",
    "set_op_big_distributed": "dbigsetops",
    "order_by_big": "bigorderby",
    "order_by_big_distributed": "dbigorderby",
    "quantile_big": "bigquantile",
    "quantile_big_distributed": "dbigquantile",
    "top_k_big": "bigtopk",
    "window_big": "bigwindow",
    "window_big_distributed": "dbigwindow",
    "top_k_big_distributed": "dbigtopk",
    "join_aggregate_big": "bigpipe",
    "join_aggregate_big_distributed": "dbigpipe",
    "aggregate_big_distributed": "dbigagg",
    "join_big_distributed": "dbigjoin",
}


def __getattr__(name):
    if name in _BIG_EXPORTS:
        import importlib
        mod = importlib.import_module(
            f"tpu_qe_torch.ops.{_BIG_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'tpu_qe_torch.ops' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_BIG_EXPORTS))
