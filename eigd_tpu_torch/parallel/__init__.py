"""The sharded solve on ``torch.distributed``: grid partitions
(``grid``), the rank launcher (``launch``), the halo operators, factors
and sharded objectives (``sharded``, ``mgshard``) and the rank functions
the tests and the smoke run launch (``runs``)."""

from .grid import GridPartition, make_axis, make_partition  # noqa: F401
from .sharded import (  # noqa: F401
    GridHaloOperator,
    SchwarzPCGFactor,
    make_sharded_objective,
    sharded_element_matvec,
    sharded_train_step,
)
