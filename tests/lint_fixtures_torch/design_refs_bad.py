"""Deliberate dangling design citation (lint fixture of the port's linter).

See DESIGN.md §99 for a section that does not exist."""  # LINT-EXPECT: design-refs
