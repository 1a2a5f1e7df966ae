"""Step assignment, the stage processes and the step pipeline, and the
single-device reference run."""
