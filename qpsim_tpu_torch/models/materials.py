"""Literature reference values for common superconducting films.

Parity with the reference app's material table
(reference ``qpsim/ui/dialogs.py:25-107``), exposed as a typed,
programmatically queryable registry instead of a GUI-only table.

Fields per material: critical temperature T_c [K], single-particle gap
Δ(0) [μeV], nominal normal-state electron diffusion coefficient D₀ [μm²/ns]
(plus a literature range), and the characteristic electron–phonon time
τ₀ [ns] from Kaplan et al.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MaterialReference:
    key: str
    material: str
    Tc_K: float
    gap_ueV: float
    D0_nom: float
    D0_range: str
    D0_unit: str
    tau_0_ns: float
    refs: tuple[tuple[str, str], ...] = field(default_factory=tuple)
    notes: str = ""


MATERIALS: dict[str, MaterialReference] = {
    m.key: m
    for m in (
        MaterialReference(
            key="al",
            material="Aluminum (Al)",
            Tc_K=1.2,
            gap_ueV=180.0,
            D0_nom=6.0,
            D0_range="2–10",
            D0_unit="μm²/ns",
            tau_0_ns=440.0,
            refs=(
                ("Chi & Clarke, PRB 19 (1979)", "D ≈ 60 cm²/s in thin films"),
                ("Heikkilä et al., arXiv:1911.02434", "D = 100 cm²/s (nanothermometry)"),
                ("Hubbell & Briscoe, PRL 20 (1968)", "D = 22.5 cm²/s (first measurement)"),
            ),
            notes=(
                "Widely used in transmon qubits. D₀ varies ~20–100 cm²/s depending on "
                "film quality/thickness."
            ),
        ),
        MaterialReference(
            key="nb",
            material="Niobium (Nb)",
            Tc_K=9.25,
            gap_ueV=1530.0,
            D0_nom=1.0,
            D0_range="0.5–2",
            D0_unit="μm²/ns",
            tau_0_ns=0.15,
            refs=(
                ("Kaplan et al., PRB 14 (1976)", "Recombination/scattering times; BCS parameters"),
                ("SQMS / Bal et al., PRApplied 20 (2023)", "QP spectroscopy in Nb transmon films"),
            ),
            notes=(
                "Strong-coupling superconductor (2Δ/k_BT_c ≈ 3.8). Short mean free path in "
                "sputtered films gives low D₀."
            ),
        ),
        MaterialReference(
            key="ta",
            material="Tantalum (Ta)",
            Tc_K=4.47,
            gap_ueV=700.0,
            D0_nom=0.82,
            D0_range="0.5–1.5",
            D0_unit="μm²/ns",
            tau_0_ns=1.8,
            refs=(("Poelaert et al., PRB 61 (2000)", "D = 8.2 cm²/s, τ = 83 μs at 0.21 K (STJ)"),),
            notes="Used in STJ X-ray detectors and emerging qubit platforms. Longer QP lifetime than Nb.",
        ),
        MaterialReference(
            key="sn",
            material="Tin (Sn)",
            Tc_K=3.72,
            gap_ueV=575.0,
            D0_nom=3.0,
            D0_range="2–4",
            D0_unit="μm²/ns",
            tau_0_ns=2.3,
            refs=(("Kittel, Intro Solid State Physics", "Δ = 0.575 meV, standard BCS values"),),
            notes="Classical low-T_c superconductor. Less commonly used in modern devices.",
        ),
        MaterialReference(
            key="nbn",
            material="NbN",
            Tc_K=16.0,
            gap_ueV=2460.0,
            D0_nom=0.05,
            D0_range="0.02–0.1",
            D0_unit="μm²/ns",
            tau_0_ns=0.02,
            refs=(("Il'in et al., 2019 (NbN thin films)", "D ~ 0.5 cm²/s, strongly disordered"),),
            notes="Highly disordered; very short mean free path. Used in SNSPDs.",
        ),
        MaterialReference(
            key="tin",
            material="TiN",
            Tc_K=4.5,
            gap_ueV=700.0,
            D0_nom=0.1,
            D0_range="0.05–0.3",
            D0_unit="μm²/ns",
            tau_0_ns=1.5,
            refs=(("Leduc et al., APL 2010", "Used in KID detectors; disordered thin films"),),
            notes="Tunable T_c via nitrogen content. Used in kinetic inductance detectors.",
        ),
    )
}


def material_reference_table() -> list[MaterialReference]:
    """Return all known materials in display order."""
    return list(MATERIALS.values())


def lookup_material(name: str) -> MaterialReference:
    """Look a material up by key ('al') or display name prefix ('Aluminum')."""
    key = name.strip().lower()
    if key in MATERIALS:
        return MATERIALS[key]
    for mat in MATERIALS.values():
        if mat.material.lower().startswith(key):
            return mat
    raise KeyError(f"Unknown material: {name!r}. Known: {sorted(MATERIALS)}")
