"""Step assignment and the single-device reference run."""
