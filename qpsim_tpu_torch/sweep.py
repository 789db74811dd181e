"""Parameter sweeps over saved setups — calibration curves in one call.

Carried over from ``qpsim_tpu.sweep``: a saved setup plus one or more vary
axes expands into variants, each run through
:func:`qpsim_tpu_torch.runner.run_setup` (same persistence contract as a
single run) and summarized into one machine-readable JSON.  Variants run
one after another (each builds its own program: the collision tables
depend on the physics parameters); ``device`` and the other run options
pass through to ``run_setup``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from pathlib import Path
from typing import Any, Callable

from .models.params import (
    ExternalGenerationSpec,
    PhotonDriveSpec,
    SetupData,
    SimulationParameters,
)

__all__ = ["parse_vary", "build_variants", "apply_overrides", "run_sweep"]

# Sweepable numeric/bool fields, validated against the dataclasses so typos
# fail before any variant runs.
_PARAM_FIELDS = {
    f.name: f.type
    for f in dataclasses.fields(SimulationParameters)
    if f.name not in ("collision_solver", "gap_expression", "external_generation", "photon_drive")
}
_GEN_FIELDS = {
    f.name: f.type
    for f in dataclasses.fields(ExternalGenerationSpec)
    if f.name not in ("mode", "custom_body", "custom_params")
}
_PHOTON_FIELDS = {
    f.name: f.type
    for f in dataclasses.fields(PhotonDriveSpec)
    if f.name != "mode"
}
_INT_FIELDS = {"store_every", "num_energy_bins"}
_BOOL_FIELDS = {
    "enable_diffusion",
    "enable_recombination",
    "enable_scattering",
    "export_phonon_history",
    "include_scattering",
    "include_pair_breaking",
}


def _parse_value(field: str, token: str) -> Any:
    token = token.strip()
    name = field.split(".")[-1]
    if name in _BOOL_FIELDS:
        low = token.lower()
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"'{field}' is boolean; got '{token}'.")
    try:
        value = float(token)
    except ValueError:
        raise ValueError(f"Value '{token}' for '{field}' is not numeric.") from None
    if name in _INT_FIELDS:
        if value != int(value):
            raise ValueError(f"'{field}' takes integers; got '{token}'.")
        return int(value)
    return value


def parse_vary(spec: str) -> tuple[str, list[Any]]:
    """Parse one ``--vary`` axis: ``FIELD=v1,v2,...`` or ``FIELD=lo:hi:N``.

    FIELD is a :class:`SimulationParameters` field name or
    ``external_generation.<field>``; the range form is an inclusive
    N-point linspace.  Returns ``(field, values)``.
    """
    field, sep, body = spec.partition("=")
    field = field.strip()
    if not sep or not body.strip():
        raise ValueError(f"--vary needs FIELD=VALUES, got '{spec}'.")
    if field.startswith("external_generation."):
        sub = field.split(".", 1)[1]
        if sub not in _GEN_FIELDS:
            allowed = ", ".join(sorted(_GEN_FIELDS))
            raise ValueError(
                f"Unknown generation field '{sub}'. Sweepable: {allowed}."
            )
    elif field.startswith("photon_drive."):
        sub = field.split(".", 1)[1]
        if sub not in _PHOTON_FIELDS:
            allowed = ", ".join(sorted(_PHOTON_FIELDS))
            raise ValueError(
                f"Unknown photon-drive field '{sub}'. Sweepable: {allowed}."
            )
    elif field not in _PARAM_FIELDS:
        allowed = ", ".join(sorted(_PARAM_FIELDS))
        raise ValueError(f"Unknown parameter '{field}'. Sweepable: {allowed}.")

    body = body.strip()
    if ":" in body and "," not in body:
        parts = body.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"Range for '{field}' must be START:STOP:COUNT, got '{body}'."
            )
        lo, hi = float(parts[0]), float(parts[1])
        count = int(parts[2])
        if count < 1:
            raise ValueError(f"Range count for '{field}' must be >= 1.")
        if count == 1:
            raw = [lo]
        else:
            step = (hi - lo) / (count - 1)
            raw = [lo + i * step for i in range(count)]
        values = [_parse_value(field, repr(v)) for v in raw]
    else:
        values = [_parse_value(field, tok) for tok in body.split(",") if tok.strip()]
    if not values:
        raise ValueError(f"--vary '{spec}' produced no values.")
    return field, values


def apply_overrides(setup: SetupData, overrides: dict[str, Any]) -> SetupData:
    """A copy of ``setup`` with dotted-field overrides applied and re-validated.

    ``tau_0`` overrides clear ``tau_s``/``tau_r`` so the convenience alias
    resolves from the swept value (the loaded setup carries concrete
    ``tau_s``/``tau_r``, which would otherwise pin ``tau_0`` to their mean).
    """
    param_kw: dict[str, Any] = {}
    gen_kw: dict[str, Any] = {}
    photon_kw: dict[str, Any] = {}
    for field, value in overrides.items():
        if field.startswith("external_generation."):
            gen_kw[field.split(".", 1)[1]] = value
        elif field.startswith("photon_drive."):
            photon_kw[field.split(".", 1)[1]] = value
        else:
            param_kw[field] = value
    if "tau_0" in param_kw:
        param_kw.setdefault("tau_s", None)
        param_kw.setdefault("tau_r", None)
    gen = setup.parameters.external_generation
    if gen_kw:
        gen = dataclasses.replace(gen, **gen_kw)
    drive = setup.parameters.photon_drive
    if photon_kw:
        if isinstance(drive, (list, tuple)):
            raise ValueError(
                "photon_drive.<field> sweep axes need a single-mode drive; "
                "this setup carries a multi-tone photon_drive list. Sweep by "
                "editing the setup JSON per variant instead."
            )
        drive = dataclasses.replace(drive, **photon_kw)
    params = dataclasses.replace(
        setup.parameters, external_generation=gen, photon_drive=drive, **param_kw
    )
    return dataclasses.replace(setup, parameters=params)


def build_variants(
    setup: SetupData,
    axes: list[tuple[str, list[Any]]],
    mode: str = "product",
) -> list[tuple[dict[str, Any], SetupData]]:
    """Expand vary axes into ``(overrides, variant_setup)`` pairs.

    ``product`` crosses every axis; ``zip`` pairs them index-by-index
    (all axes must then have equal lengths).  Every variant is validated
    at build time, so a bad corner fails before anything runs.
    """
    if not axes:
        raise ValueError("A sweep needs at least one --vary axis.")
    if mode == "product":
        combos: list[dict[str, Any]] = [{}]
        for field, values in axes:
            combos = [{**c, field: v} for c in combos for v in values]
    elif mode == "zip":
        lengths = {len(values) for _, values in axes}
        if len(lengths) != 1:
            raise ValueError(
                "zip mode needs equal-length axes, got "
                + ", ".join(f"{f}×{len(v)}" for f, v in axes)
            )
        combos = [
            {field: values[i] for field, values in axes}
            for i in range(lengths.pop())
        ]
    else:
        raise ValueError(f"Unknown sweep mode '{mode}' (product|zip).")
    return [(c, apply_overrides(setup, c)) for c in combos]


def _slug(overrides: dict[str, Any]) -> str:
    parts = []
    for field, value in overrides.items():
        name = field.split(".")[-1]
        parts.append(f"{name}={value:g}" if isinstance(value, float) else f"{name}={value}")
    return "_".join(parts).replace("/", "-")


def run_sweep(
    setup: SetupData,
    axes: list[tuple[str, list[Any]]],
    *,
    mode: str = "product",
    out_dir: str | Path,
    setup_path: str | Path | None = None,
    save_results: bool = True,
    resume: bool = False,
    progress: Callable[[str], None] | None = None,
    **run_kwargs: Any,
) -> dict[str, Any]:
    """Run every variant sequentially and write ``sweep_summary.json``.

    Per variant the summary records the overrides, the saved result path,
    final time, mass initial/peak/final, and the energy totals the runner
    computes (``energy_qp_total``/``energy_phonon_total`` finals).  A
    variant that raises is recorded with its error and the sweep continues
    — a 50-point calibration curve should not lose 49 results to one bad
    corner.  With ``resume=True`` a variant whose result file already
    exists and loads is summarized from disk instead of re-run, so an
    interrupted sweep picks up where it stopped.  Extra keyword arguments
    pass through to :func:`qpsim_tpu_torch.runner.run_setup` (device,
    backends, strang mode, dtype; stream/checkpoint dirs are per-run and
    not supported here) and enter the settings stamp that ``resume``
    checks.
    """
    from .io.storage import load_simulation
    from .runner import run_setup

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    variants = build_variants(setup, axes, mode)

    # Settings stamp: a resumed sweep must run under the SAME settings as
    # the interrupted one, or reused variants would silently mix physics
    # (e.g. frozen-bath results spliced into a dynamic-bath curve, or
    # merged-vs-exact stepping differing beyond calibration tolerances).
    # Stable reprs: memory addresses vary between processes (a resumed
    # sweep is a NEW process), so normalize them away — otherwise a
    # passed-through callable/object kwarg would make resume refuse
    # forever.  The setup CONTENT is hashed, not just its id: editing a
    # physics field in the setup file between runs must refuse too.
    def stable(v: Any) -> str:
        return re.sub(r"0x[0-9a-fA-F]+", "0x?", repr(v))

    from .io.storage import serialize_setup

    setup_hash = hashlib.sha256(
        json.dumps(serialize_setup(setup), sort_keys=True).encode()
    ).hexdigest()
    settings = {
        "setup_id": setup.setup_id,
        "setup_hash": setup_hash,
        "mode": mode,
        "axes": [[f, [stable(v) for v in vals]] for f, vals in axes],
        "run_kwargs": {k: stable(v) for k, v in sorted(run_kwargs.items())},
    }
    settings_path = out / "sweep_settings.json"
    if resume and settings_path.exists():
        try:
            prior_settings = json.loads(settings_path.read_text())
        except ValueError:
            # a damaged stamp cannot certify consistency — refuse rather
            # than silently splice physics (the guard's whole purpose)
            raise ValueError(
                f"resume=True but '{settings_path}' is damaged and cannot "
                "certify the interrupted run's settings.  Re-run without "
                "--resume to recompute everything."
            ) from None
        if prior_settings != settings:
            diffs = [
                k
                for k in set(prior_settings) | set(settings)
                if prior_settings.get(k) != settings.get(k)
            ]
            raise ValueError(
                "resume=True but the sweep settings differ from the "
                f"interrupted run ({', '.join(sorted(diffs))} changed; see "
                f"{settings_path}).  Re-run without --resume (recomputes "
                "everything) or restore the original settings."
            )
    tmp = settings_path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(settings, indent=2))
    tmp.replace(settings_path)  # atomic: a torn write can't defeat the guard
    records: list[dict[str, Any]] = []
    for i, (overrides, variant) in enumerate(variants):
        label = _slug(overrides)
        if progress is not None:
            progress(f"[{i + 1}/{len(variants)}] {label}")
        record: dict[str, Any] = {"index": i, "overrides": overrides}
        result_path = out / f"{i:03d}_{label}.json"
        if resume and save_results and result_path.exists():
            # ANY failure to load/summarize the prior file means it is not a
            # usable result (truncated write, schema damage, empty times):
            # fall through and re-run the variant instead of aborting the
            # sweep — a 50-point curve must not lose 49 results to one bad
            # file
            try:
                prior = load_simulation(result_path)
                mass = prior.mass_over_time
                meta = prior.metadata
                record.update(
                    result_path=str(result_path),
                    final_time=prior.times[-1],
                    mass_initial=mass[0],
                    mass_final=mass[-1],
                    mass_peak=max(mass),
                    energy_qp_final=meta.get("energy_qp_total", [None])[-1],
                    energy_phonon_final=meta.get("energy_phonon_total", [None])[-1],
                    resumed=True,
                )
            except Exception:  # noqa: BLE001 — damaged partial file
                record = {"index": i, "overrides": overrides}
            else:
                records.append(record)
                continue
        try:
            result, saved = run_setup(
                variant,
                setup_path=setup_path,
                save=save_results,
                save_path=result_path if save_results else None,
                **run_kwargs,
            )
        except Exception as exc:  # noqa: BLE001 — isolate per variant
            record["error"] = f"{type(exc).__name__}: {exc}"
            records.append(record)
            continue
        mass = result.mass_over_time
        meta = result.metadata
        record.update(
            result_path=saved,
            final_time=result.times[-1],
            mass_initial=mass[0],
            mass_final=mass[-1],
            mass_peak=max(mass),
            energy_qp_final=meta.get("energy_qp_total", [None])[-1],
            energy_phonon_final=meta.get("energy_phonon_total", [None])[-1],
        )
        if "save_error" in meta:
            record["save_error"] = meta["save_error"]
        records.append(record)

    summary = {
        "setup_id": setup.setup_id,
        "setup_name": setup.name,
        "mode": mode,
        "axes": [{"field": f, "values": v} for f, v in axes],
        "n_variants": len(variants),
        "n_failed": sum(1 for r in records if "error" in r),
        "variants": records,
    }
    summary_path = out / "sweep_summary.json"
    summary_path.write_text(json.dumps(summary, indent=2))
    summary["summary_path"] = str(summary_path)
    return summary
