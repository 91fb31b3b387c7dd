"""An allow that silences nothing (lint fixture)."""

X = 1  # repro-torch-lint: allow(mirror-write)  # LINT-EXPECT: unused-suppression
