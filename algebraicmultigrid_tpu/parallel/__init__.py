from .dist import (
    build_sharded_hierarchy,
    make_row_mesh,
    shard_hierarchy,
    solve_sharded,
)
from .halo import lat2d_spmv_halo, shard_slab
from .lattice_cycle import (
    build_slab_hierarchy,
    cycle_lattice_sharded,
    matvec_lattice_sharded,
    place_slab_hierarchy,
    solve_lattice_sharded,
)
