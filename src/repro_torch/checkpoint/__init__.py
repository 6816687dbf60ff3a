"""Atomic, bounded checkpoints of the train state (port of
``repro.checkpoint``)."""
from .checkpoint import (  # noqa: F401
    all_steps,
    latest_step,
    load_arrays,
    nest,
    restore,
    restore_migrating,
    save,
)
