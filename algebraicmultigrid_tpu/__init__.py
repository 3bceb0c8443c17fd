"""algebraicmultigrid_tpu — an algebraic multigrid framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
``JuliaLinearAlgebra/AlgebraicMultigrid.jl`` (reference mounted read-only at
``/root/reference``; structural analysis in ``SURVEY.md``).  Not a port: the
run-once hierarchy setup executes as vectorised host kernels (numpy/scipy,
with native C++ acceleration for the sequential graph algorithms), while the
solve hot path runs as jitted static-shape JAX on device operator levels —
with multicolor relaxation replacing sequential Gauss-Seidel, device-resident
dense coarse solves, and ``shard_map`` row-partitioned distribution across a
device mesh.  The accelerator it is built for is an NVIDIA GPU (H100).

Public API mirrors the reference's names and defaults (survey §2, §5.6).
"""

from .config import (
    BackwardSweep,
    Cycle,
    F,
    ForwardSweep,
    GaussSeidel,
    Jacobi,
    SOR,
    Sweep,
    SymmetricSweep,
    V,
    W,
)
from .models.aggregate import StandardAggregation
from .models.aggregation import fit_candidates, smoothed_aggregation
from .models.classical import ruge_stuben
from .models.coarse import LinearSolveWrapper, Pinv, QRSolver, SpluSolver
from .models.gallery import poisson, stencil_grid
from .models.lattice import LatticeMatrix, LatticeProblem
from .models.lattice_nd import (
    BoxAggregationND,
    LatticeMatrixND,
    LatticeProblemND,
    structured_smoothed_aggregation_nd,
)
from .models.fastsetup import (
    structured_ruge_stuben,
    structured_smoothed_aggregation,
)
from .models.interpolation import direct_interpolation
from .models.multilevel import (
    Level,
    MultiLevel,
    grid_complexity,
    operator_complexity,
    solve_mg,
)
from .models.prolongation_smooth import JacobiProlongation
from .models.splitting import RS, rs_cf_splitting
from .models.parallel_setup import LabelPropAggregation, PMIS
from .models.structured import StructuredAggregation, StructuredRS
from .models.strength import Classical, SymmetricStrength
from .models.preconditioner import Preconditioner, aspreconditioner
from .models.precs import (
    RugeStubenPreconBuilder,
    SmoothedAggregationPreconBuilder,
)
from .models.api import (
    AMGSolver,
    RugeStubenAMG,
    SmoothedAggregationAMG,
    init,
    solve,
)
from .ops.krylov import cg
from .models.device import cg_device, solve_refined
from .utils.arnoldi import approximate_spectral_radius
from .utils.serialize import load_hierarchy, save_hierarchy
from .utils.symmetry import HermitianSymmetry, NoSymmetry

__version__ = "0.1.0"

__all__ = [
    # cycles & sweeps
    "Cycle", "V", "W", "F", "Sweep", "SymmetricSweep", "ForwardSweep", "BackwardSweep",
    # smoothers
    "GaussSeidel", "Jacobi", "SOR",
    # strength / splitting / aggregation
    "Classical", "SymmetricStrength", "RS", "StructuredRS", "rs_cf_splitting",
    "StandardAggregation", "StructuredAggregation", "fit_candidates",
    "PMIS", "LabelPropAggregation",
    "JacobiProlongation",
    "direct_interpolation",
    # hierarchy
    "ruge_stuben", "smoothed_aggregation", "Level", "MultiLevel", "solve_mg",
    "operator_complexity", "grid_complexity",
    # coarse solvers
    "Pinv", "QRSolver", "LinearSolveWrapper", "SpluSolver",
    # preconditioner / Krylov
    "Preconditioner", "aspreconditioner", "cg", "cg_device", "solve_refined",
    "RugeStubenPreconBuilder", "SmoothedAggregationPreconBuilder",
    # CommonSolve-style API
    "AMGSolver", "RugeStubenAMG", "SmoothedAggregationAMG", "solve", "init",
    # lattice fast path
    "LatticeMatrix", "LatticeProblem", "structured_ruge_stuben",
    "structured_smoothed_aggregation",
    "LatticeMatrixND", "LatticeProblemND", "BoxAggregationND",
    "structured_smoothed_aggregation_nd",
    # gallery & utils
    "poisson", "stencil_grid", "approximate_spectral_radius",
    "HermitianSymmetry", "NoSymmetry",
    "save_hierarchy", "load_hierarchy",
]
