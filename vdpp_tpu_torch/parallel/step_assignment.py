"""Step assignment for pipeline-parallel diffusion inference.

The port's own copy of ``vdpp_tpu/parallel/step_assignment.py`` (pure Python,
no imports from the JAX package). ``assign_steps`` maps (total_steps,
world_size, rank) to a contiguous half-open ``[start, end)`` slice and fails
on a non-divisible split; non-divisible schedules are padded with identity
steps instead (``EulerKarrasSchedule.create(pad_to_multiple_of=...)``).
``assign_steps_uneven`` is a diagnostics-only remainder-distribution helper.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StepRange:
    """The half-open slice ``[start, end)`` of the schedule one stage owns."""

    start: int
    end: int

    def __post_init__(self) -> None:
        if self.start < 0 or self.end < 0:
            raise ValueError(
                f"negative step index in range [{self.start}, {self.end})"
            )
        if self.end < self.start:
            raise ValueError(
                f"inverted step range: end {self.end} precedes start {self.start}"
            )

    @property
    def count(self) -> int:
        """How many steps the slice covers."""
        return self.end - self.start

    def __iter__(self):
        yield from range(self.start, self.end)


def _validate(total_steps: int, world_size: int, rank: int) -> None:
    if total_steps <= 0:
        raise ValueError(f"total_steps needs to be >= 1, got {total_steps}")
    if world_size <= 0:
        raise ValueError(f"world_size needs to be >= 1, got {world_size}")
    if not 0 <= rank < world_size:
        raise ValueError(
            f"rank {rank} outside the valid range [0, {world_size})"
        )


def assign_steps(total_steps: int, world_size: int, rank: int) -> StepRange:
    """Uniform contiguous step slice for ``rank``.

    Raises:
        ValueError: on inconsistent arguments or when ``total_steps`` is not
            divisible by ``world_size`` (uniform splits are a correctness
            contract: every stage must do identical work per tick for the
            SPMD pipeline schedule to be bubble-free in steady state).
    """
    _validate(total_steps, world_size, rank)
    if total_steps % world_size != 0:
        raise ValueError(
            f"uniform assignment needs total_steps ({total_steps}) divisible "
            f"by world_size ({world_size}); pad the schedule "
            "(EulerKarrasSchedule pad_to_multiple_of) or use "
            "assign_steps_uneven for diagnostics"
        )
    steps_per_rank = total_steps // world_size
    start = rank * steps_per_rank
    return StepRange(start=start, end=start + steps_per_rank)


def assign_steps_uneven(total_steps: int, world_size: int, rank: int) -> StepRange:
    """Near-even contiguous split: the first ``total_steps % world_size``
    stages take one extra step.

    Extension beyond the reference (which mandates even splits,
    src/pipeline/step_assignment.py:60-63). Analysis/diagnostic helper only
    (deliberately NOT in the top-level API): the production path for
    non-divisible schedules is identity-step padding
    (``EulerKarrasSchedule.create(pad_to_multiple_of=...)``,
    vdpp_tpu_torch/diffusion/scheduler.py), which keeps per-tick work
    uniform while producing bit-identical output to the unpadded schedule.
    """
    _validate(total_steps, world_size, rank)
    base, rem = divmod(total_steps, world_size)
    start = rank * base + min(rank, rem)
    end = start + base + (1 if rank < rem else 0)
    return StepRange(start=start, end=end)
