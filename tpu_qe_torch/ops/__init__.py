"""In-core query operators (the port of tpu_qe/ops, in-core part).

Every data sort goes through tpu_qe_torch.sort.planes (the radix kernels
on the card; ``backend="torch"`` for the torch.sort baseline). The
out-of-core family is not ported yet (ROADMAP Queue A).
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
