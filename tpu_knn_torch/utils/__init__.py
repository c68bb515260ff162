"""RNG, logging and timing helpers."""
