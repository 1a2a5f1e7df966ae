"""Noise schedules and solver updates."""
