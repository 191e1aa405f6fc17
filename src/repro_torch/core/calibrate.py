"""Per-device cost calibration for the transform planner.

:func:`repro_torch.core.coarsen.plan_strategy` prices every strategy ×
transform combination with a launch-cost/padded-FLOP model.  The
coefficients of that model are device properties — how expensive a kernel
launch is relative to a gathered FMA, how wide the lanes are, whether a
fused one-launch solve exists — so they live here in one
:class:`BackendCalibration` row per device family, keyed by the solver's
``torch.device`` type:

``cpu``   the JAX package's historical planner constants, unchanged (the
          rows the CPU parity tests price with): ``fused_max_rows=0``, so
          the fused solve is never a candidate there
``cuda``  measured on an NVIDIA H100 by :mod:`repro_torch.bench.calibrate`
          (see the row's comment for the card): the port's ``pallas_fused``
          and ``blocked`` are each one launch per solve
          (``fused_num_launches="one"``), 32-wide warps, ``x`` in device
          memory

A table measured on another card replaces the shipped row:
``python -m repro_torch.bench.calibrate --json calibration.json`` writes
one; :func:`load_calibrations` / :func:`refresh` merge it over the defaults
(rows keep ``source="measured"`` so ``plan.reason`` lines stay auditable).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Union

__all__ = [
    "BackendCalibration",
    "DEFAULT_CALIBRATIONS",
    "get_calibration",
    "load_calibrations",
    "save_calibrations",
    "refresh",
]


@dataclasses.dataclass(frozen=True)
class BackendCalibration:
    """Planner pricing coefficients for one device family, in
    FLOP-equivalents (the planner's common currency).

    ``launch_cost``            one kernel launch (a barrier between segments)
    ``substep_cost``           one sub-step of a coarsened chain inside a
                               segment (no barrier, no new launch)
    ``gather_cost``            relative price of one padded gather/FMA flop
                               (1.0 = the reference throughput)
    ``serial_step_cost``       per-row base cost of the ``serial`` solver
    ``serial_step_cost_scale`` its growth with n
    ``lane_width``             lane width rows are padded to
    ``fused_max_rows``         largest n the fused one-dispatch solve can
                               hold (0 = never a candidate on this device)
    ``fused_num_launches``     ``"one"`` — the whole fused solve is one
                               launch; ``"per_level"`` — one per wavefront
    ``gemm_cost``              relative price of one dense diagonal-block
                               flop of the blocked solve
    ``trsm_cost``              fixed per-diagonal-block overhead of the
                               blocked apply
    ``mixed_gather_discount``  multiplier on ``gather_cost`` when the guard's
                               ``precision="mixed"`` stores values in bf16
    ``source``                 ``"default"`` (shipped) or ``"measured"``
    """

    backend: str
    launch_cost: float = 4096.0
    substep_cost: float = 2048.0
    gather_cost: float = 1.0
    serial_step_cost: float = 16.0
    serial_step_cost_scale: float = 0.06
    lane_width: int = 8
    fused_max_rows: int = 0
    fused_num_launches: str = "per_level"
    gemm_cost: float = 0.25
    trsm_cost: float = 64.0
    mixed_gather_discount: float = 0.75
    source: str = "default"

    def __post_init__(self):
        if self.fused_num_launches not in ("one", "per_level"):
            raise ValueError(
                f"fused_num_launches must be 'one' or 'per_level', got "
                f"{self.fused_num_launches!r}")


DEFAULT_CALIBRATIONS: Dict[str, BackendCalibration] = {
    # The JAX package's host row, unchanged: what the CPU tests price with.
    "cpu": BackendCalibration(backend="cpu"),
    # NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi name, power.limit),
    # measured by `python -m repro_torch.bench.calibrate` (its docstring
    # says what each coefficient is measured with).  lane_width,
    # fused_max_rows, fused_num_launches, substep_cost and
    # mixed_gather_discount are facts of the port, not timings: a warp is
    # 32 lanes, x̂ lives in device memory, B3/B4 each run a solve in one
    # launch.
    "cuda": BackendCalibration(
        backend="cuda",
        launch_cost=5394930.1,
        gather_cost=1.0,
        serial_step_cost=11075820.18,
        serial_step_cost_scale=31.5552,
        lane_width=32,
        fused_max_rows=50_000_000,
        fused_num_launches="one",
        gemm_cost=0.2225,
        trsm_cost=3804.13,
        mixed_gather_discount=0.55,
        source="measured",
    ),
}


def get_calibration(
    key: str,
    table: Optional[Dict[str, BackendCalibration]] = None,
) -> BackendCalibration:
    """Calibration row for a device family (``cpu`` / ``cuda``).  ``table``
    overrides the shipped rows row by row (rows it does not carry fall
    through to the defaults)."""
    if table is not None and key in table:
        return table[key]
    try:
        return DEFAULT_CALIBRATIONS[key]
    except KeyError:
        raise ValueError(
            f"no calibration for device family {key!r}; expected one of "
            f"{sorted(DEFAULT_CALIBRATIONS)}") from None


def save_calibrations(path: Union[str, Path],
                      table: Dict[str, BackendCalibration]) -> None:
    """Write a calibration table as JSON (one object per device family)."""
    payload = {k: dataclasses.asdict(v) for k, v in sorted(table.items())}
    Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


def load_calibrations(path: Union[str, Path]) -> Dict[str, BackendCalibration]:
    """Read a table written by :func:`save_calibrations`.  Unknown keys in a
    row are ignored so old tables survive field additions; a file that is
    not a JSON object of per-device rows raises ``ValueError`` naming the
    path."""
    try:
        raw = json.loads(Path(path).read_text())
    except json.JSONDecodeError as err:
        raise ValueError(f"malformed calibration file {path}: {err}") from None
    if not isinstance(raw, dict):
        raise ValueError(
            f"malformed calibration file {path}: expected a JSON object of "
            f"device rows, got {type(raw).__name__}")
    fields = {f.name for f in dataclasses.fields(BackendCalibration)}
    table = {}
    for key, row in raw.items():
        if not isinstance(row, dict):
            raise ValueError(
                f"malformed calibration file {path}: row {key!r} is not an "
                f"object")
        kw = {k: v for k, v in row.items() if k in fields}
        kw.setdefault("backend", key)
        table[key] = BackendCalibration(**kw)
    return table


def refresh(path: Union[str, Path]) -> Dict[str, BackendCalibration]:
    """Defaults overlaid with a measured table (missing file → defaults)."""
    table = dict(DEFAULT_CALIBRATIONS)
    p = Path(path)
    if p.exists():
        table.update(load_calibrations(p))
    return table
