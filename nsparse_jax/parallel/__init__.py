from nsparse_jax.parallel.mesh import make_mesh
from nsparse_jax.parallel.partition import PartitionedCSR, partition_rows
from nsparse_jax.parallel.spmv import spmv_dist
from nsparse_jax.parallel.spgemm import (spgemm_dist, rap_dist,
                                          gather_partitioned)
from nsparse_jax.parallel.halo import (
    BandedPartitionedCSR,
    partition_banded,
    shard_x,
    spmv_halo,
)
from nsparse_jax.parallel.spgemm_halo import (
    HaloSpgemmPlan,
    rap_halo,
    spgemm_halo,
    spgemm_halo_plan,
)

__all__ = [
    "make_mesh",
    "PartitionedCSR",
    "partition_rows",
    "spmv_dist",
    "spgemm_dist",
    "rap_dist",
    "gather_partitioned",
    "BandedPartitionedCSR",
    "partition_banded",
    "shard_x",
    "spmv_halo",
    "HaloSpgemmPlan",
    "rap_halo",
    "spgemm_halo",
    "spgemm_halo_plan",
]
