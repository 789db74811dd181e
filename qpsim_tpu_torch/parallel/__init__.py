"""Ensembles on one card, the device mesh and the spatially sharded step.

The port of ``qpsim_tpu.parallel``: :mod:`.ensemble` (film ensembles and
diffusion sweeps), :mod:`.mesh` (meshes of devices, local or over a
``torch.distributed`` group, and the exchanges between their shards) and
:mod:`.sharded` (the rows-sharded Strang step the engine's ``mesh=`` runs).
"""

from .ensemble import FilmEnsemble, build_diffusion_sweep_step, build_film_ensemble, sweep_diffusion_decay
from .mesh import (
    ENSEMBLE_AXIS,
    SPACE_AXIS,
    Mesh,
    initialize_distributed,
    local_devices,
    make_mesh,
    make_multihost_mesh,
    state_sharding,
)
from .sharded import ShardedStep, build_sharded_step

__all__ = [
    "ENSEMBLE_AXIS",
    "FilmEnsemble",
    "Mesh",
    "SPACE_AXIS",
    "ShardedStep",
    "build_diffusion_sweep_step",
    "build_film_ensemble",
    "build_sharded_step",
    "initialize_distributed",
    "local_devices",
    "make_mesh",
    "make_multihost_mesh",
    "state_sharding",
    "sweep_diffusion_decay",
]
