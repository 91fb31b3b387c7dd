"""Suppressed dangling design citation (lint fixture)."""

# historical section, kept for the suppression test
X = "DESIGN.md §99"  # repro-torch-lint: allow(design-refs)
