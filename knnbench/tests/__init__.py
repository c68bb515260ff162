"""The benchmark's own tests (CPU; the card ones skip without a card)."""
