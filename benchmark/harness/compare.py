"""The numbers that decide ``correct``: each one a gap between what the
program produced and what the plain reference works out from the same
inputs, and each held to a limit of its own (``cells/<cell>.json``)."""

from __future__ import annotations

import statistics

import numpy as np

# Leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone, and are not compared.
NEGLIGIBLE_GRADIENT = 1e-3


def relative_gap(program: float, reference: float) -> float:
    return abs(program - reference) / abs(reference)


def leaf_gaps(program: dict, reference: dict, names) -> dict:
    """``|program norm - reference norm|`` of each leaf of ``names``, against
    the larger of its reference norm and the median leaf's."""
    floor = statistics.median(reference[n] for n in names)
    return {n: abs(program[n] - reference[n]) / max(reference[n], floor) for n in names}


def counted_leaves(reference_grads: dict) -> list[str]:
    floor = NEGLIGIBLE_GRADIENT * statistics.median(reference_grads.values())
    return [n for n, g in reference_grads.items() if g >= floor]


def training_numbers(program: dict, reference: dict) -> tuple[dict, dict]:
    """(numbers, details) of a training cell: the worst step's relative loss
    gap and the first step's; of the first gradient's norm, of the
    parameters' change and of the EMA's change after the steps, the worst
    counted leaf's gap and the median leaf's."""
    leaves = counted_leaves(reference["grad_norms"])
    buffers = [n for n in reference["ema_change_norms"] if n not in reference["grad_norms"]]
    gaps = [relative_gap(p, r) for p, r in zip(program["losses"], reference["losses"])]
    numbers = {"loss_gap": max(gaps), "loss_gap_first": gaps[0]}
    details = {"losses": program["losses"], "reference_losses": reference["losses"], "leaves_compared": len(leaves),
               "leaves_left_out": sorted(set(reference["grad_norms"]) - set(leaves))}
    for name, key, names in (("grad", "grad_norms", leaves), ("change", "change_norms", leaves),
                             ("ema", "ema_change_norms", leaves + buffers)):
        gaps = leaf_gaps(program[key], reference[key], names)
        worst = max(gaps, key=gaps.get)
        numbers[f"{name}_gap"] = gaps[worst]
        numbers[f"{name}_gap_median"] = statistics.median(gaps.values())
        details[f"worst_{name}_leaf"] = worst
    return numbers, details


def output_gaps(program: np.ndarray, reference: np.ndarray) -> dict:
    """Two gaps of one answer: the widest, against its largest reference
    value, and the root-mean-square one, against the reference's."""
    if program.shape != reference.shape:
        return {"output_gap": float("inf"), "output_rms_gap": float("inf")}
    diff = program.astype(np.float64) - reference
    scale = float(np.max(np.abs(reference)))
    rms = float(np.sqrt(np.mean(np.square(reference, dtype=np.float64))))
    return {"output_gap": float(np.max(np.abs(diff))) / scale if scale > 0 else float(np.max(np.abs(diff))),
            "output_rms_gap": float(np.sqrt(np.mean(np.square(diff)))) / rms if rms > 0 else float("inf")}


def worst_answer(gaps: list[dict]) -> dict:
    """Each gap's worst over the answers compared (NaN with none)."""
    keys = ("output_gap", "output_rms_gap")
    return {k: max(g[k] for g in gaps) if gaps else float("nan") for k in keys}


def verdicts(numbers: dict, limits: dict) -> tuple[bool, list]:
    """Whether every number is within its limit (a NaN is not), and the
    ``[name, number, limit]`` rows, in the limits' order."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        ok = ok and bool(value <= limit)
        rows.append([name, value, limit])
    return ok, rows
