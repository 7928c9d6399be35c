"""HetCCL core: the paper's contribution in PyTorch.

Hierarchical heterogeneous collectives over process groups (topology
abstraction, cluster-level primitives, Algorithm-1 breakdowns, pipelined
execution), the alpha-beta cost model, compression of the cross-cluster
hop, the discrete-event transport simulator for the paper's §4.1
mechanism, the cost-model-driven communication planner that turns the
two models into per-bucket ``CommConfig`` decisions (DESIGN.md §6), and
the compute-skew-aware workload partitioner that jointly optimizes the
uneven batch split with the communication plan (DESIGN.md §10).  The
names are the JAX package's, each bound to the port's own object;
nothing here builds a kernel.
"""

from .collectives import (  # noqa: F401
    CommConfig,
    FlatShardMeta,
    comm_layout,
    hier_all_gather,
    hier_all_to_all,
    hier_psum,
    hier_psum_scatter,
    tree_hier_psum,
    tree_hier_psum_mean,
    resolve_config,
    tree_hier_psum_scatter,
    tree_hier_unscatter,
    zero1_local_shard,
)
from .packing import (  # noqa: F401
    PackedLayout,
    comm_alignment,
    plan_layout,
)
from .planner import (  # noqa: F401
    BucketPlan,
    CommPlan,
    plan,
    plan_for_param_bytes,
)
from .skew import (  # noqa: F401
    SkewPlan,
    SkewSplit,
)
from .topology import (  # noqa: F401
    Cluster,
    HetTopology,
    LinkSpec,
    integer_split,
    paper_testbed,
    proportional_split,
    three_vendor_testbed,
    tpu_multipod,
    tpu_pod_cluster,
)
