"""Hierarchy checkpointing (survey §5.4).

The reference has no checkpoint subsystem; its tests only load fixtures.
Here the hierarchy is a plain pytree of arrays + static config, so it
serializes to a single ``.npz``: scipy levels as CSR triples, lattice levels
as their compact coefficient tables (a few KB regardless of problem size —
the O(boundary) representation is also the O(boundary) checkpoint).

``save_hierarchy(ml, path)`` / ``load_hierarchy(path)`` round-trip the host
``MultiLevel``; the device caches are rebuilt lazily on first use, so
a loaded hierarchy solves identically on any backend.
"""

from __future__ import annotations

import io
import json

import numpy as np
import scipy.sparse as sp

from ..config import BackwardSweep, ForwardSweep, GaussSeidel, Jacobi, SOR, SymmetricSweep
from ..models.coarse import Pinv, QRSolver
from ..models.lattice import LatticeMatrix, LatticeSpec
from ..models.multilevel import Level, MultiLevel
from ..utils.symmetry import HermitianSymmetry, NoSymmetry

__all__ = ["save_hierarchy", "load_hierarchy"]

_SWEEPS = {"Symmetric": SymmetricSweep, "Forward": ForwardSweep, "Backward": BackwardSweep}


def _cfg_to_json(cfg):
    if cfg is None:
        return None
    kind = type(cfg).__name__
    out = {"kind": kind, "iter": cfg.iter}
    if isinstance(cfg, (GaussSeidel, SOR)):
        out["sweep"] = type(cfg.sweep).__name__.replace("Sweep", "")
        out["ordering"] = cfg.ordering
    if isinstance(cfg, (Jacobi, SOR)):
        out["omega"] = float(cfg.omega)
    return out


def _cfg_from_json(d):
    if d is None:
        return None
    if d["kind"] == "GaussSeidel":
        return GaussSeidel(_SWEEPS[d["sweep"]](), iter=d["iter"], ordering=d.get("ordering", "natural"))
    if d["kind"] == "SOR":
        return SOR(d["omega"], _SWEEPS[d["sweep"]](), iter=d["iter"], ordering=d.get("ordering", "natural"))
    if d["kind"] == "Jacobi":
        return Jacobi(omega=d["omega"], iter=d["iter"])
    raise ValueError(f"unknown smoother config {d['kind']}")


def _put_matrix(store, prefix, M):
    if isinstance(M, LatticeMatrix):
        s = M.spec
        store[f"{prefix}_kind"] = "lattice"
        store[f"{prefix}_table"] = s.table
        store[f"{prefix}_meta"] = json.dumps(
            {
                "offsets": [list(o) for o in s.offsets],
                "row_dims": list(s.row_dims),
                "col_dims": list(s.col_dims),
                "K": [s.Kx, s.sx, s.Ky, s.sy],
                "base": [list(s.base_x), list(s.base_y)],
            }
        )
        return
    C = sp.csr_matrix(M)
    store[f"{prefix}_kind"] = "csr"
    store[f"{prefix}_data"] = C.data
    store[f"{prefix}_indices"] = C.indices
    store[f"{prefix}_indptr"] = C.indptr
    store[f"{prefix}_shape"] = np.asarray(C.shape)


def _get_matrix(z, prefix):
    kind = str(z[f"{prefix}_kind"])
    if kind == "lattice":
        meta = json.loads(str(z[f"{prefix}_meta"]))
        spec = LatticeSpec(
            offsets=tuple(tuple(o) for o in meta["offsets"]),
            table=z[f"{prefix}_table"],
            row_dims=tuple(meta["row_dims"]),
            col_dims=tuple(meta["col_dims"]),
            Kx=meta["K"][0],
            sx=meta["K"][1],
            Ky=meta["K"][2],
            sy=meta["K"][3],
            base_x=tuple(meta["base"][0]),
            base_y=tuple(meta["base"][1]),
        )
        return LatticeMatrix(spec)
    return sp.csr_matrix(
        (z[f"{prefix}_data"], z[f"{prefix}_indices"], z[f"{prefix}_indptr"]),
        shape=tuple(z[f"{prefix}_shape"]),
    )


def save_hierarchy(ml: MultiLevel, path: str) -> None:
    store = {}
    meta = {
        "n_levels": len(ml.levels),
        "symmetry": type(ml.symmetry).__name__ if ml.symmetry is not None else "HermitianSymmetry",
        "coarse": type(ml.coarse_solver).__name__,
        "configs": [
            [_cfg_to_json(l.presmoother_config), _cfg_to_json(l.postsmoother_config)]
            for l in ml.levels
        ],
    }
    store["meta"] = json.dumps(meta)
    for i, l in enumerate(ml.levels):
        _put_matrix(store, f"L{i}_A", l.A)
        _put_matrix(store, f"L{i}_P", l.P)
        _put_matrix(store, f"L{i}_R", l.R)
    _put_matrix(store, "final_A", ml.final_A)
    np.savez_compressed(path, **store)


def load_hierarchy(path: str) -> MultiLevel:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    sym = HermitianSymmetry() if meta["symmetry"] == "HermitianSymmetry" else NoSymmetry()
    levels = []
    for i in range(meta["n_levels"]):
        pre, post = meta["configs"][i]
        levels.append(
            Level(
                A=_get_matrix(z, f"L{i}_A"),
                P=_get_matrix(z, f"L{i}_P"),
                R=_get_matrix(z, f"L{i}_R"),
                presmoother_config=_cfg_from_json(pre),
                postsmoother_config=_cfg_from_json(post),
                symmetry=sym,
            )
        )
    final_A = _get_matrix(z, "final_A")
    cs = (Pinv if meta["coarse"] == "Pinv" else QRSolver)(
        final_A.tocsr() if hasattr(final_A, "tocsr") else final_A
    )
    return MultiLevel(levels, final_A, cs, symmetry=sym)
