"""Ensembles on one card (the port of ``qpsim_tpu.parallel.ensemble``).

The JAX package's ``parallel`` also holds the device mesh and the sharded
step; those are not ported yet (ROADMAP.md, queue 1 item 12).
"""

from .ensemble import FilmEnsemble, build_diffusion_sweep_step, build_film_ensemble, sweep_diffusion_decay

__all__ = ["FilmEnsemble", "build_diffusion_sweep_step", "build_film_ensemble", "sweep_diffusion_decay"]
