"""FePIA robustness metrics (Ali et al. 2004), as applied in the paper §4.1.

For a performance feature φ = parallel loop execution time T_par and a
perturbation parameter π (failures or perturbations):

    robustness radius   r_DLS(φ, π) = T_par^π − T_par^orig
    resilience          ρ_res(φ, π) = r_DLS / r_minDLS   (π = PE failures)
    flexibility         ρ_flex(φ, π) = r_DLS / r_minDLS  (π = perturbations)

ρ = 1 denotes the most robust technique in a scenario; larger ρ means
"that many times less robust than the best" (lower is better, Figs. 4-5).
"""

from __future__ import annotations

import math
from typing import Mapping


def robustness_radius(t_perturbed: float, t_baseline: float) -> float:
    """r_DLS = T_par^π − T_par^orig (inf when the perturbed run hangs)."""
    if math.isinf(t_perturbed):
        return math.inf
    return max(0.0, t_perturbed - t_baseline)


def robustness_metric(radii: Mapping[str, float]) -> dict[str, float]:
    """ρ(φ,π) per technique = r_DLS / min over techniques (paper Fig. 4/5).

    Techniques that hang (r = inf) get ρ = inf.  If the minimum radius is 0
    (a technique fully absorbed the perturbation), ratios use a small floor
    so the most-robust technique still maps to 1.0.
    """
    finite = [r for r in radii.values() if not math.isinf(r)]
    if not finite:
        return {k: math.inf for k in radii}
    r_min = min(finite)
    floor = max(r_min, 1e-9)
    out = {}
    for k, r in radii.items():
        if math.isinf(r):
            out[k] = math.inf
        elif r_min <= 1e-9:
            out[k] = 1.0 if r <= 1e-9 else r / floor
        else:
            out[k] = r / r_min
    return out


def flexibility(t_perturbed: Mapping[str, float],
                t_baseline: Mapping[str, float]) -> dict[str, float]:
    """ρ_flex per technique, from per-technique perturbed/baseline times."""
    radii = {k: robustness_radius(t_perturbed[k], t_baseline[k])
             for k in t_perturbed}
    return robustness_metric(radii)


def resilience(t_failed: Mapping[str, float],
               t_baseline: Mapping[str, float]) -> dict[str, float]:
    """ρ_res per technique (identical machinery, π = failures)."""
    return flexibility(t_failed, t_baseline)
