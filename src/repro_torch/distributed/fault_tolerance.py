"""Fault tolerance and elastic scaling plans.

On TPU pods, a failed host removes a fixed block of chips; the recovery path
is (1) pick a degraded mesh among the survivors, (2) re-derive shardings with
the same rules on the new mesh, (3) restore parameters from the latest
checkpoint, (4) rescale the data pipeline.  All of that is deterministic
planning logic — testable on CPU — plus the checkpoint layer.

The serving-side analogue (device churn in the Multi-SPIN cell) is handled by
``serving.cell`` re-solving draft control for the survivor set; here we
handle the training/verification cluster itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axis_names: tuple
    lost_fraction: float
    batch_scale: float          # keep global batch via grad-accum scaling
    notes: str


def degraded_mesh_plan(current_shape: tuple, axis_names: tuple,
                       failed_chips: int, chips_per_host: int = 4) -> MeshPlan:
    """Largest well-formed mesh after losing ``failed_chips`` chips.

    Policy: shrink the ``data`` axis (model/pod axes carry sharded parameter
    state whose re-layout is expensive; the data axis only re-slices the
    batch).  The global batch is preserved by raising per-step gradient
    accumulation on the survivors.
    """
    axes = dict(zip(axis_names, current_shape))
    total = int(np.prod(current_shape))
    failed_hosts = int(np.ceil(failed_chips / chips_per_host))
    lost = failed_hosts * chips_per_host

    data = axes.get("data", 1)
    per_data_row = total // data
    rows_lost = int(np.ceil(lost / per_data_row))
    new_data = data - rows_lost
    if new_data < 1:
        raise RuntimeError("failure exceeds recoverable capacity; "
                           "restore on a fresh allocation")
    new_axes = dict(axes, data=new_data)
    new_shape = tuple(new_axes[a] for a in axis_names)
    return MeshPlan(
        shape=new_shape,
        axis_names=axis_names,
        lost_fraction=lost / total,
        batch_scale=data / new_data,
        notes=(f"dropped {rows_lost} data row(s) after {failed_chips} chip "
               f"failures; raise grad-accum x{data / new_data:.2f} to keep "
               f"the global batch"),
    )


def expansion_mesh_plan(current_shape: tuple, axis_names: tuple,
                        new_chips: int) -> MeshPlan:
    """Elastic scale-UP: grow the data axis by whole rows."""
    axes = dict(zip(axis_names, current_shape))
    total = int(np.prod(current_shape))
    per_data_row = total // axes.get("data", 1)
    add_rows = new_chips // per_data_row
    new_axes = dict(axes, data=axes["data"] + add_rows)
    new_shape = tuple(new_axes[a] for a in axis_names)
    return MeshPlan(shape=new_shape, axis_names=axis_names, lost_fraction=0.0,
                    batch_scale=axes["data"] / new_axes["data"],
                    notes=f"added {add_rows} data row(s)")


@dataclasses.dataclass
class RecoveryPlan:
    mesh_plan: MeshPlan
    restore_step: int
    resume_data_step: int

    @classmethod
    def build(cls, mesh_plan: MeshPlan, checkpoint_steps: list[int]) -> "RecoveryPlan":
        if not checkpoint_steps:
            raise RuntimeError("no checkpoint to recover from")
        step = max(checkpoint_steps)
        return cls(mesh_plan=mesh_plan, restore_step=step,
                   resume_data_step=step)


def straggler_policy(step_times: np.ndarray, threshold: float = 2.0) -> dict:
    """Detect persistent stragglers from per-host step-time telemetry.

    Returns {"stragglers": idx array, "action": ...}.  Single-slow-step blips
    are ignored (median filter); persistent outliers are flagged for
    re-scheduling (their data shard reassigned, host drained).
    """
    med = np.median(step_times, axis=-1)          # per-host median over window
    global_med = np.median(med)
    stragglers = np.where(med > threshold * global_med)[0]
    return {
        "stragglers": stragglers,
        "action": "drain-and-redistribute" if len(stragglers) else "none",
        "severity": float(np.max(med) / global_med) if len(med) else 1.0,
    }
