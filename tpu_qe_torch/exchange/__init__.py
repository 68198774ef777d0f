"""The multi-device layer (the port of tpu_qe/exchange): a mesh of shards
(mesh.py), the keyed shuffle (shuffle.py), the distributed sort
(dsort.py), the distributed operators of dops.py, the distributed ORDER
BY (dorderby.py), quantiles (dquantile.py) and window functions
(dwindow.py).
"""

from tpu_qe_torch.exchange.mesh import (  # noqa: F401
    GroupMesh,
    LocalMesh,
)
from tpu_qe_torch.exchange.dsort import (  # noqa: F401
    DistSortResult,
    distributed_sort,
    distributed_sort_numpy,
    make_mesh,
)
from tpu_qe_torch.exchange.dops import (  # noqa: F401
    distributed_aggregate,
    distributed_aggregate_numpy,
    plan_aggregate_capacity,
    distributed_count_distinct,
    distributed_count_distinct_numpy,
    plan_count_distinct_capacity,
    distributed_join_aggregate,
    distributed_join_aggregate_numpy,
    distributed_join_fk,
    distributed_join_fk_numpy,
    distributed_join_inner,
    distributed_join_inner_numpy,
    plan_join_inner_capacity,
    distributed_set_op,
    distributed_set_op_numpy,
    distributed_top_k,
    distributed_top_k_numpy,
)
from tpu_qe_torch.exchange.dorderby import (  # noqa: F401
    distributed_order_by,
    distributed_order_by_numpy,
    plan_order_by_capacity,
)
from tpu_qe_torch.exchange.dquantile import (  # noqa: F401
    distributed_group_quantile,
    distributed_group_quantile_numpy,
    distributed_quantile,
    distributed_quantile_numpy,
)
from tpu_qe_torch.exchange.dwindow import (  # noqa: F401
    DistWindowResult,
    distributed_window,
    distributed_window_numpy,
    plan_window_capacity,
)
from tpu_qe_torch.exchange.shuffle import (  # noqa: F401
    AXIS,
    exchange,
    route_by_splitters,
    sample_splitters,
)

NOT_PORTED: tuple = ()


def __getattr__(name):
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
